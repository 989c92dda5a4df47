#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU: build, check, time, serve, train.

    python3 chip_smoke.py          # from the repo root, on a machine with a CUDA GPU

Phases, each fatal on failure (nothing is caught and carried on):
  1. card and software: the nvidia-smi name and power limit, torch and CUDA
     versions; TF32 is switched off for matmuls and cuDNN.
  2. build the CUDA libraries from gat_recommendation_torch/csrc with nvcc
     (in parallel) and print the build seconds and register counts; count
     the instructions and reciprocals of the lazy series loop in the
     compiled gather and materialize (cuobjdump -sass), which their bounds
     in phase 7 use, and fail if the loop still holds an IEEE division's
     check (FCHK).
  3. each kernel against its plain PyTorch version on the card, at the
     serving shapes (attention B=1, N in {8,16,32,56}, and B=512, N=56;
     scoring B=1 over the full 467,456-row table), plus an integer-valued
     tie case through the full exact top-k at B=1 and at B=130 (the tiled
     kernel, a ragged session tile). Times of the kernel, the plain
     version and a library yardstick: device time from a CUDA graph of 20
     calls (median of 10 replays), and eager time per call with the host's
     dispatch (median of 30 after warm-up), both from CUDA events. Then the
     two kernels inside each wrapper against each other: the attention
     forward (one warp per destination, one block per session and head) at
     B in {1,8,16,32,64,128,512}, N in {8,16,32,56}, and scoring (one warp per chunk,
     the tiled product) at B in {1,2,4,8,16,64,512}, with the kernel the
     wrapper chooses at each size. Beside each B=1 attention row the launch
     floor: an empty kernel of the same grid, block and shared memory, timed
     from the same kind of graph (at B=1 the bytes bound says nothing).
  4. the serving slice at full width: a seeded optimized Graph Transformer
     (466,865 items, D=256, 2 layers, 2 heads) saved through the port's
     checkpoint, a synthetic 737,716-edge co-occurrence graph, the
     Recommender on cuda behind the stdlib HTTP server, 12 POST /recommend
     requests over all four node buckets, each checked and compared with a
     CPU copy of the port (the plain versions).
  5. the kernels' launch counters over phase 4: 2 attention launches and 1
     scoring launch per request, none of them through the batch kernels.
  6. a torch.profiler breakdown of the same requests (device busy time,
     idle share, the kernels by device time).
  7. the training kernels against their plain versions on the card, at the
     train shapes: attention forward and backward at B=512, N in {8, 56},
     without dropout and with dropout 0.1 from one seed (the keep bits are
     the same by construction), N in {16, 32} with dropout, two backward runs
     bit-equal at every shape, the kernels reading the packed rows as the
     trainers do and held bit for bit against the bool route; the sparse and the dense AdamW over the full
     467,456 x 256 table, float32 moments and bfloat16 moments with
     stochastic rounding (moments bit-equal); the score kernel at the eval
     batch of 512, also with a [B, V] exclusion mask. Times, bounds and
     library yardsticks as in phase 3. The three lazy AdamW kernels at full
     width, float32 moments and bfloat16 moments with stochastic rounding,
     rows 0 .. 65 and several hundred steps behind, uid 0 and a sentinel
     tail: weights TABLE_TOL, moments and last_step equal, rows outside uid
     unchanged; materialize timed from single calls on a restored state.
     The gather's and materialize's bounds: bytes, the series loop's
     instructions counted in phase 2 and one reciprocal an element and term
     (16 lanes an SM and clock), beside the earlier bound of 13
     instructions an element and term (the series with an IEEE division).
     Node dropout at [512, 56, 256], rate 0.1, forward and backward equal to
     the plain version bit for bit.
  8. the training slice at full width: seeded synthetic sessions through
     SessionDataset and iterate_batches(batch_size=512) (the default engine,
     the C++ one of data/native.py), a Trainer epoch of
     6 sparse steps over all four buckets, 6 more sparse steps on one batch
     (the loss must fall), 2 dense steps, all with dropout 0.1, then
     Trainer.evaluate and the eval step's top-20 against the dense oracle;
     with dropout 0, two sparse steps on the card against a CPU copy of the
     port. The launch counters over the counted steps: 2 attention forward,
     2 attention backward and 1 sparse AdamW per sparse step; 2, 2 and 1
     dense AdamW per dense step; 2 attention forward and 1 scoring launch
     per eval batch; every attention forward through the staged kernel and
     the eval batch's scoring through the tiled one. Then the main training
     path, the lazy optimizer through Trainer.train(): 3 epochs of those 6
     batches with an evaluation each, counted (per step 2 attention forward,
     2 backward, 1 gather and 1 touched update, no sparse AdamW; per
     evaluation 1 materialize); a 2-epoch run resumed to epoch 3 with the
     same losses and metrics; the seconds and bytes of every checkpoint
     save and restore; a Recommender on the best checkpoint; two lazy steps
     against a CPU copy; six lazy and six eager steps after materialize.
     Every train step with dropout counts 4 node-dropout launches (2 layers,
     forward and backward). Then the chained path: Trainer.train() with
     chain=CHAIN on a corpus whose smallest bucket forms a full group and a
     sub-chain, against the unchained run of the same seed (history and state
     equal bit for bit, both chained counters above zero, the same counts per
     step); a replayed lazy step against the eager one; eager sparse groups
     of 4 against eager steps.
  9. a torch.profiler breakdown of sparse train steps, and the attention
     kernels timed once more at a training batch's own adjacency (sparser
     than the 0.3 of phase 7), with that density and its bound; beside them
     lazy steps (rows a few steps behind, then 1,000) and one materialize;
     lazy steps at N = 56 at chain 1 and chain TIMED_CHAIN (wall and device
     ms per step, profile, host launch calls, graphs, capture seconds, pool
     bytes).
 10. the host's batch engines: one epoch of the chained corpus assembled by
     the C++ engine (data/native.py, built with g++ at first use; phase 8's
     batches come from it) and by the numpy engine, ms per batch of each;
     the epochs equal but for the negatives.
 11. the host pipeline: chained Trainer.train() (chain=CHAIN) from a cold
     graph cache with the epoch assembled by iterate_batches on 3 threads and
     transferred by prefetch_to_device on 3 threads (side stream), against
     the inline epoch (phase 8's batches, one transfer thread): history and
     state equal bit for bit; the port's bench
     (gat_recommendation_torch.bench.main_e2e, lazy, BENCH_SESSIONS sessions
     over the full catalog, slope window BENCH_EPOCHS) at chain 32 and
     chain 1, each with workers/transfer_workers 3/3 and 0/1, each line with
     the idle share of one traced epoch and the touched rows (the first run
     counted: per step 2 attention forward, 2 backward, 1 gather, 1 touched
     update, 4 node dropout); the latency bench
     (gat_recommendation_torch.serving.latency_bench, run inside phase 4 on
     its checkpoint: p50, p95, p99 over 200 requests, counted).
 12. the rest of the model zoo: kernel 1 at the standard Graph Transformer's
     4 heads of 64, B=512, N in {8, 56}, forward and backward with dropout 0.1
     against the plain version (timed, bounds and library as in phase 7);
     node dropout at GAT's attention weights [512, 4, 56, 56], the LSTM's
     [512, 32, 256] and the FFN's [512, 56, 1024]; the smoke entry's kernels
     at its own shapes (attention B=8, N=8 at 4 heads of 8 and 2 of 16,
     forward and backward; node dropout [8, 8, 128], [8, 8, 32],
     [8, 4, 8, 8]; the dense AdamW on [512, 32]), each against its plain
     version; then each of GAT, GraphSAGE (mean, max, lstm) and the standard Graph
     Transformer (3 layers, 4 heads, the FFN) at full width: a lazy
     Trainer.train() of 2 epochs of phase 8's batches (the LSTM's up to
     N = 32) with dropout 0.1, counted (per step 1 gather, 1 touched update,
     node dropout GAT 10, GraphSAGE 6, Graph Transformer 18, its attention 3
     forward and 3 backward; per evaluation 1 materialize), the loss falling
     on one repeated batch, a lazy step's ms at its largest bucket from a
     torch.profiler trace with the peak device memory, two lazy steps against
     a CPU copy, each from the card's state and on the card's side of every
     ReLU, LeakyReLU and max-aggregator switch (the switches that differed
     counted; zoo_against_cpu_copy); GAT and the Graph Transformer at chain 4 equal to the
     unchained run bit for bit; a GAT and a GraphSAGE-mean checkpoint behind
     the Recommender over phase 4's 12 requests against a CPU copy (1 scoring
     launch a request, no attention), p50; Laplacian PE of the bench's
     default corpus graph (precompute_pe, seconds) and one request of the
     optimized Graph Transformer with it against a CPU copy; the port's
     smoke_test_all_models, its main() counted in this process and
     ``python3 -m`` in a child, which must exit 0. First of all, every model
     of the registry at full width drawn from seed 0 of a CPU generator on
     the card and on the CPU, and a seeded Trainer.init_state() over the main
     path's model on both: the states EQUAL bit for bit, each draw's seconds.
 13. the Quickstart on the card, through the port's entry points, in a
     temporary directory: (a) corpus v3 regenerated from data_refscale/
     MANIFEST.json by the port's pandas-free pipeline (scripts.data.
     regen_refscale.generate; seconds a stage; the six CSV and JSON files
     must match their sha256, the npz must hold the CSV's arrays; its own
     sha256 printed); (b) train_baseline.main with the JAX script's defaults
     (the optimized Graph Transformer at 466,864 items and D = 256, batch 128,
     eager sparse AdamW, chain 32, 3 / 2 threads, dropout 0.1) for 2 epochs:
     per step 2 attention forward, 2 backward, 1 sparse AdamW, 4 node
     dropout, per evaluation batch 2 attention forward and 1 scoring, chained
     dispatches above 0, seconds an epoch, sessions a second, evaluation, save
     and PE seconds, and the best val recall@10 at least 0.25 (printed beside
     the JAX TPU history's 0.2883 and 0.3362); (c) --lazy-adamw --batch-size
     512 for 2 epochs (per step 1 gather and 1 touched update, per evaluation
     1 materialize), then --resume to 3 epochs with the first two unchanged;
     (d) evaluate_local on both output dirs (test.csv, batch 256, counted) and
     the quality gate on (b)'s checkpoint_best with the repo's thresholds:
     artifact and latency pass, its metrics equal evaluate_local's within
     1e-9, exit 0 exactly when every phase passed (after 2 epochs the NDCG
     floors are not expected to hold: exit 1, with its failures); (e)
     run_full_pipeline with its defaults: exit 0, all four models passing,
     kernel 4 once a step; (f) every kernel of those paths against its plain
     version at that path's own shapes, timed with its bound: the attention
     at every node bucket the path fills (with the forward kernel each
     took), the row-sized AdamW kernels at the unique rows of real batches
     of corpus v3 at the path's batch size.
 14. what serving still lacked, on phase 4's checkpoint and edges (written
     again from the same seeds): phase 4's 12 requests over HTTP through
     Recommender(int8_scoring=True) on the card (the forward on the card,
     the int8 scan and the float32 re-rank on the host; counted: 2 attention
     launches a request, no scoring launch), each request's top 10 equal to
     the exact path's (kernel 2) but for near-ties, scores within
     SERVE_TOL, p50/p95/p99 of both modes over the latency bench's 200
     requests; full_catalog_topk(method="approx") at B=1 (the serving mask)
     and B=512, ids equal to the exact path's (counted: 1 scoring launch a
     call), and the exact path on the table cut to its 466,865 real rows
     (off the 32-row chunk: kernel 2 on a padded copy, counted, equal);
     two_level_topk at chunks 8, 16 and 64 against chunk 32 (ids
     equal but for near-ties of kernel 2's and cuBLAS's scores within
     SELECT_TOL; no kernel at those chunks), each selector timed eagerly;
     the dev and the Vertex-style server (scripts/serve) over HTTP on the
     card's copy of the table: every route (/health, /recommend,
     /recommend/batch; /predict, /metrics, /drift), answers against a CPU
     copy (the first 50), HTTP p50/p95/p99 over the latency bench's 200
     requests and the dev model's p50 by stage in process, the no-op Metrics and the
     dataclass schemas where prometheus_client and pydantic are absent;
     scripts/bench_scoring once (B=512, full catalog, counted).
 15. the study and tool scripts and the bit-packed adjacency: (f) kernel 1
     reading the packed rows [B, N, ceil(N/8)] against its bool route (bit
     for bit) and its plain version at (b)'s shapes (the eval forward, B=512,
     every bucket) and (c)'s (forward and backward, B=128, every bucket, 2
     and 4 heads), each timed beside the bool route with its bound restated
     for the packed bytes (the checks of phases 7, 12 and 13 at the shapes of
     the paths that copy batches to the card take the packed form too); then
     (a) scripts.pipeline.validate_sr_onchip's three checks (counted: 2,003
     sparse AdamW launches); (b) scripts.bench_attention at B=512 over every
     bucket (every forward reads packed rows); (c)
     scripts.pipeline.corpus_discrimination on a small corpus, the four
     families at D=256 for two epochs (kernels 1-3 and node dropout
     counted); (d) scripts.train.run_ablations on phase 13's corpus v3, one
     ablation for one epoch (the dense step: kernel 4 counted); (e)
     scripts.data.convert_yoochoose on 220,000 written events; (g) on every
     path that copies batches to the card (phases 8, 11, 12 and 13) each
     kernel 1 launch read the packed rows, and serving's none; phase 11's sessions a
     second beside.
 16. the mesh (parallel/, ROADMAP A8 and B1): (a) B1, kernel 3 on each row
     shard, at full width (467,456 x 256, U = 16,384 with 12,000 unique),
     float32 and bf16+SR moments, the table in 1, 2, 4 and 8 shards (views of
     one table): the shards put together EQUAL one kernel 3 call, the plain
     twin within TABLE_TOL (moments equal), each shard timed (a graph of 20
     calls, median of 10 replays) beside its bound, plain and library ms;
     (b) a process group of one over NCCL (MASTER_ADDR 127.0.0.1, a free
     port) and a 1x1 mesh: full-width Trainers (lazy, eager through B1,
     dense through kernel 4 on the shard; dropout 0.1; 4 steps of 512, an
     evaluation of 2 batches) against the single-GPU Trainer from the same
     weights and batches (loss 1e-5, state 1e-6, metrics and top-k ids equal,
     dropout masks equal, also of two simulated data ranks' halves), the lazy
     mesh run saved and loaded on one GPU; (c) bench --mesh 1x1 --chain 1
     against --chain 1 on phase 11's 30,000 sessions, one pair, mesh first,
     each with a traced epoch (sessions/s, busy seconds, idle share; every
     run with its windows' host account); (d) the
     chained mesh (A8b): full-width Trainers on the 1x1 NCCL mesh at chain 32
     (lazy, and eager through B1; dropout 0.1; an epoch of phase 11's corpus,
     whose smallest bucket holds a full group and a partial one, and an
     evaluation) EQUAL to the same Trainers at chain 1 on the mesh and to the
     single-GPU Trainer at chain 32 (state, loss, metrics, top-k ids), with
     the NCCL version, the chained dispatches and the graphs, captured with
     the NCCL collectives inside (no fallback); (e) bench --mesh 1x1 --chain
     32 against --chain 32 on the same sessions, in turns mesh, plain, plain,
     mesh; each bench's timed epoch split by what the host did. The mesh
     path's launches ((b)'s and (d)'s mesh runs, the mesh
     bench of (c) and the first of (e)) counted, the chained ones through the
     graph replays.
 17. the Quickstart's export step, the tracked runs and the first optimizer
     of a process: (a) scripts.pipeline.export_onnx --mode production on
     phase 13 (b)'s checkpoint_best (its optimizer file dropped in phase 13):
     item_embeddings.npy EQUAL to the table restore_params_state gives, in
     its padded shape, the metadata with the JAX script's keys, the scorer
     check under 1e-4, the export's seconds and its scoring p50/p95 (50
     requests, each read back); --mode demo --num-items 466865, timed; (b)
     the Vertex-style server with MODEL_DIR on (a)'s export answers phase
     14's 200 requests through /predict EQUAL to the server built from the
     checkpoint as phase 14 built its own, and on phase 4's checkpoint
     exported the same way EQUAL to phase 14's server's answers (the
     phantom ids answered, and a session of one phantom id, printed); (c)
     scripts.pipeline.mlflow_experiment for each of the four models on the
     card (2 epochs, counted: per dense step 1 dense AdamW; node dropout
     and kernel 1 as the model's layers take them), from the script's own
     seed (weights drawn on the host, so the card's run starts from the CPU
     run's weights), against the script's CPU run: params equal, losses finite and
     within MLFLOW_LOSS_RTOL; kernel 1 and node dropout at that path's
     shapes (B = 16, N = 8) against their plain versions; (d) beside (c), a
     child process (collector off) builds a full-width lazy Trainer inside a
     function and drops it, twice: memory_allocated back to its level
     before each build, the MiB freed printed.
 18. a JSON line of each phase's seconds, a JSON line of every kernel's
     numbers, then the nvidia-smi line, then {"ok": true, "device": {...}}
     as the last line.

Exits nonzero without a CUDA device, and without the package beside it.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

from gat_recommendation_torch import bench, smoke_test_all_models
from gat_recommendation_torch.data.batching import (
    UID_SENTINEL,
    SessionBatch,
    SessionDataset,
    iterate_batches,
    pick_bucket,
    make_grad_index,
    stack_batches,
    stack_grad_indices,
    to_device,
)
from gat_recommendation_torch.data.csv_io import read_csv
from gat_recommendation_torch.data.graph import build_co_event_graph, load_edges
from gat_recommendation_torch.models.base import padded_rows
from gat_recommendation_torch.models.registry import MODEL_NAMES, create_model
from gat_recommendation_torch.ops import _build, step_block
from gat_recommendation_torch.ops.embedding_adamw import (
    embedding_adamw,
    embedding_adamw_reference,
)
from gat_recommendation_torch.ops.lazy_adamw import (
    gather_catch_up,
    gather_catch_up_reference,
    materialize,
    materialize_reference,
    touched_update_scatter,
    touched_update_scatter_reference,
)
from gat_recommendation_torch.ops.masked import dropout as node_dropout_reference
from gat_recommendation_torch.ops.node_dropout import node_dropout
from gat_recommendation_torch.ops.score_chunkmax import (
    score_chunkmax,
    score_chunkmax_reference,
    score_chunkmax_variant,
)
from gat_recommendation_torch.ops.scoring import (
    approx_topk,
    dense_topk,
    full_catalog_topk,
    select_topk,
    two_level_topk,
)
from gat_recommendation_torch.ops.session_attention import (
    session_attention,
    session_attention_backward,
    session_attention_launch_floor,
    session_attention_reference,
    session_attention_variant,
)
from gat_recommendation_torch.ops import shard
from gat_recommendation_torch.ops.sparse_adamw import (
    sharded_sparse_adamw,
    sharded_sparse_adamw_reference,
    sparse_adamw,
    sparse_adamw_reference,
)
from gat_recommendation_torch.parallel import distributed
from gat_recommendation_torch.parallel.mesh import make_mesh
from gat_recommendation_torch.parallel.steps import active_shard
from gat_recommendation_torch.scripts import bench_attention, bench_scoring, evaluate_local
from gat_recommendation_torch.scripts.data import convert_yoochoose, regen_refscale
from gat_recommendation_torch.scripts.pipeline import (
    corpus_discrimination,
    export_onnx,
    mlflow_experiment,
    model_quality_gate,
    run_full_pipeline,
    validate_sr_onchip,
)
from gat_recommendation_torch.scripts.serve import app as dev_app
from gat_recommendation_torch.scripts.serve import vertex_app
from gat_recommendation_torch.scripts.train import run_ablations, train_baseline
from gat_recommendation_torch.serving import app, latency_bench, schemas
from gat_recommendation_torch.serving.recommender import Recommender
from gat_recommendation_torch.serving.validation import validate_request
from gat_recommendation_torch.train import checkpoint
from gat_recommendation_torch.train.losses import create_loss_function
from gat_recommendation_torch.train.optimizers import FusedEmbeddingAdamW
from gat_recommendation_torch.train.trainer import (
    SUBCHAIN,
    Trainer,
    make_chained_sparse_train_step,
    make_eval_step,
    make_sparse_train_step,
    make_train_step,
    next_steps_block,
)
from gat_recommendation_torch.utils.roofline import H100_SXM

# Published H100 SXM peaks (utils/roofline.H100_SXM): HBM3 bandwidth and
# float32 outside the tensor cores (the kernels use no TF32).
HBM_BYTES_PER_S = H100_SXM.hbm_gb_per_s * 1e9
FP32_FLOP_PER_S = H100_SXM.peak_f32_tflops * 1e12
# One float32 instruction per lane per clock: the 67 TFLOP/s count an FMA as two.
FP32_INSTRUCTIONS_PER_S = FP32_FLOP_PER_S / 2
# 32-bit integer instructions: 64 lanes an SM and clock, half the float32 lanes.
INT32_INSTRUCTIONS_PER_S = FP32_INSTRUCTIONS_PER_S / 2
# The counter hash and the keep test, per element: two rounds of mix32 (eight
# shifts, xors and multiplies each), three xors and the shift and compare.
HASH_INSTRUCTIONS = 21
# The multi-function unit (reciprocal, exp2, sqrt approximations): 16 lanes an
# SM and clock, an eighth of the float32 instructions' 128.
MUFU_PER_S = FP32_INSTRUCTIONS_PER_S / 8
# A term of the lazy catch-up series, per element, as the bound of the series
# with an IEEE division assumed it: three FMUL, two FADD and __fdiv_rn (a
# reciprocal, its Newton steps and the rounding check, about 8 instructions).
# The bound now uses the instructions counted in the compiled loop
# (lazy_series_sass); this one stays beside it as "bound_ms_ieee_division".
SERIES_INSTRUCTIONS_IEEE_DIVISION = 13

NUM_ITEMS = 466_865  # the reference catalog
NUM_EDGES = 737_716  # the reference co-occurrence graph's edge count
DIM, HEADS = 256, 2
BUCKETS = (8, 16, 32, 56)
ATTN_TOL = dict(rtol=1e-5, atol=2e-5)  # float32, summation order differs
SCORE_TOL = dict(rtol=1e-5, atol=1e-4)  # float32 dots of 256 terms, |score| ~ 16
SERVE_TOL = 1e-4  # card vs CPU copy, per score
ATTN_GRAD_TOL = dict(rtol=1e-5, atol=2e-5)  # float32 gradients, summation order differs
TABLE_TOL = dict(rtol=1e-6, atol=1e-7)  # AdamW table; the moments must be bit-equal
ADAMW = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-5)
ROWS = 467_456  # the kernel checks' table, 913 x 512 rows (the models' padded_rows(NUM_ITEMS) is 466,944)
TRAIN_BATCH, NEGATIVES, DROPOUT = 512, 5, 0.1
NUM_SESSIONS = 4000
# Card vs CPU copy of the port, dropout 0: loss; touched table rows and BatchNorm
# buffers. Where a gradient entry is itself at rounding-noise level, AdamW's
# m / (sqrt(v) + eps) turns its relative error into a share of lr = 1e-3, so the
# row tolerance holds for all but 1 entry in 10,000 and a tenth of lr caps the rest.
TRAIN_LOSS_TOL, TRAIN_ROW_TOL, TRAIN_ROW_CAP = 1e-4, 1e-5, 1e-4
# The lazy kernels' checks: the step after which the state stands, and the
# steps each row lags behind it (0 .. 65, and several hundred: the series
# stops at 64 terms).
LAZY_COUNT = 1000
LAZY_GAPS = list(range(66)) + [200, 300, 700]
# Lazy against eager sparse steps after materialize (the JAX package's
# tests/test_lazy_adamw.py bar): tail truncation and summation order.
LAZY_TABLE_TOL = dict(rtol=1e-3, atol=2e-6)
# A resumed lazy train() against an uninterrupted one: train losses.
RESUME_LOSS_RTOL = 1e-5
# Phase 8's chained Trainer: CHAIN steps a group, on a corpus of CHAIN_SESSIONS
# whose smallest node bucket holds a full group and a SUBCHAIN-long rest.
CHAIN, CHAIN_SESSIONS = 10, 13_500
# Phase 9: chain 1 against a group of TIMED_CHAIN batches of the N = 56 bucket.
TIMED_CHAIN = 32
# Phase 11: the port's bench on a corpus of BENCH_SESSIONS (the default run's
# 120,436 cut), a slope window of BENCH_EPOCHS, chain 32 and chain 1, each with
# the host pipeline on (assembly and transfer threads) and off.
BENCH_SESSIONS, BENCH_EPOCHS = 30_000, 2
BENCH_RUNS = ((32, 3, 3), (32, 0, 1), (1, 3, 3), (1, 0, 1))  # (chain, workers, transfer_workers)

REPLACES = {
    "session_attention": "gat_recommendation_tpu/ops/pallas/session_attention.py:59",
    "session_attention_backward": "gat_recommendation_tpu/ops/pallas/session_attention.py:59",
    "score_chunkmax": "gat_recommendation_tpu/ops/pallas/score_chunkmax.py:57",
    "sparse_adamw": "gat_recommendation_tpu/ops/pallas/sparse_adamw.py:117",
    "sharded_sparse_adamw": "gat_recommendation_tpu/ops/pallas/sparse_adamw.py:207",
    "embedding_adamw": "gat_recommendation_tpu/ops/pallas/embedding_adamw.py:90",
    # No Pallas source (XLA fuses this work in the JAX package): the JAX functions they stand for.
    "lazy_gather_catch_up": "gat_recommendation_tpu/train/optimizers.py:259",
    "lazy_touched_update": "gat_recommendation_tpu/train/optimizers.py:280",
    "lazy_materialize": "gat_recommendation_tpu/train/optimizers.py:312",
    "node_dropout": "gat_recommendation_tpu/ops/masked.py:95",
}
SOURCES = {
    "session_attention": "gat_recommendation_torch/csrc/session_attention.cu",
    "session_attention_backward": "gat_recommendation_torch/csrc/session_attention.cu",
    "score_chunkmax": "gat_recommendation_torch/csrc/score_chunkmax.cu",
    "sparse_adamw": "gat_recommendation_torch/csrc/embedding_adamw.cu",
    "sharded_sparse_adamw": "gat_recommendation_torch/csrc/embedding_adamw.cu",
    "embedding_adamw": "gat_recommendation_torch/csrc/embedding_adamw.cu",
    "lazy_gather_catch_up": "gat_recommendation_torch/csrc/lazy_adamw.cu",
    "lazy_touched_update": "gat_recommendation_torch/csrc/lazy_adamw.cu",
    "lazy_materialize": "gat_recommendation_torch/csrc/lazy_adamw.cu",
    "node_dropout": "gat_recommendation_torch/csrc/node_dropout.cu",
}


_START = time.perf_counter()


def log(msg: str) -> None:
    """A line of the run, after the seconds since the script started."""
    print(f"[{time.perf_counter() - _START:6.1f} s] {msg}", flush=True)


_PHASE_STARTS: dict[str, float] = {}


def phase(name: str) -> None:
    """Mark the start of phase `name` (it ends where the next one starts)."""
    _PHASE_STARTS[name] = time.perf_counter()


def phase_seconds() -> dict[str, float]:
    """The seconds of each phase so far, the last one up to now."""
    names = list(_PHASE_STARTS)
    ends = [_PHASE_STARTS[n] for n in names[1:]] + [time.perf_counter()]
    return {n: end - _PHASE_STARTS[n] for n, end in zip(names, ends)}


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def eager_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median CUDA-event time of one eager call of fn, in ms. At small shapes
    the card waits for the host's dispatch, so this is what a caller pays."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def device_ms(fn, calls: int = 20, reps: int = 10) -> float:
    """Device time of one call of fn, in ms: `calls` calls captured in one
    CUDA graph, the graph replayed `reps` times between CUDA events, the
    median divided by `calls`. The graph takes the host's dispatch out, so
    this is the card's own time (the gaps between kernels included)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    ms = statistics.median(s.elapsed_time(e) for s, e in events) / calls
    del graph
    return ms


def timings(kernel, plain, library, calls: int = 20, reps: int = 10, eager_reps: int = 30) -> dict:
    """Device and eager times of the kernel, its plain version and the library
    call (None where no PyTorch call computes the same function)."""
    return {
        "ms": device_ms(kernel, calls, reps),
        "plain_ms": device_ms(plain, calls, reps),
        "library_ms": None if library is None else device_ms(library, calls, reps),
        "eager_ms": eager_ms(kernel, eager_reps),
        "plain_eager_ms": eager_ms(plain, eager_reps),
        "library_eager_ms": None if library is None else eager_ms(library, eager_reps),
    }


def step_row(count: int) -> torch.Tensor:
    """The step block's row of the step that brings the count to `count`, on
    the card. A kernel that reads the step block is timed from a CUDA graph
    with such a row: given an int, its wrapper would copy a row from the host
    at every call, which a graph cannot replay (the wrapper raises)."""
    return step_block.one_row(count, b1=ADAMW["b1"], b2=ADAMW["b2"], device=torch.device("cuda", 0))


def seed_on_card(seed: int) -> torch.Tensor:
    """A dropout seed where the attention kernels read it (as `step_row`)."""
    return torch.tensor(step_block.as_int64(seed), device=torch.device("cuda", 0))


def bound_ms(n_bytes: float, n_flops: float, n_instructions: float = 0.0,
             n_int_instructions: float = 0.0, n_mufu: float = 0.0) -> tuple[float, str]:
    """The larger of the bytes over the memory rate and the work over the
    peak for its type: float32 operations, or, where an operation is a
    sequence (a division), issued instructions at one a lane and clock;
    32-bit integer instructions (the counter hash) at the integer lanes'
    rate; reciprocals at the multi-function unit's rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max(n_flops / FP32_FLOP_PER_S, n_instructions / FP32_INSTRUCTIONS_PER_S,
                n_int_instructions / INT32_INSTRUCTIONS_PER_S, n_mufu / MUFU_PER_S)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def cuobjdump_path() -> str:
    """cuobjdump of the toolkit whose nvcc built the kernels."""
    path = Path(_build.nvcc_path()).with_name("cuobjdump")
    if not path.exists():
        raise RuntimeError(f"{path} not found: the lazy series' instructions cannot be counted")
    return str(path)


def sass_functions(library: Path) -> dict[str, list[tuple[int, str]]]:
    """Each kernel's SASS in a library: {mangled name: [(address, instruction)]}
    (branches read `BRA 0x1a0`, the target's address)."""
    out = subprocess.run([cuobjdump_path(), "-sass", str(library)], capture_output=True, text=True,
                         check=True, timeout=120).stdout
    funcs: dict[str, list] = {}
    name = None
    for line in out.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1)
            funcs[name] = []
            continue
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if ins and name:
            funcs[name].append((int(ins.group(1), 16), ins.group(2)))
    return funcs


def series_loop_counts(body: list[tuple[int, str]]) -> dict:
    """The series loop of a lazy kernel: of the innermost loops (a backward
    branch and what lies between its target and it, holding no other loop)
    with a reciprocal (MUFU.RCP) in them, the one with the most, the
    shortest of equals (a row's setup loop has as many, and exp2). Every
    element and term of the series takes one reciprocal, so the loop's
    instructions over its reciprocals are the instructions an element and
    term; `mix` counts the loop's instructions by opcode."""
    loops = []
    for addr, text in body:
        bra = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", text)
        if bra and int(bra.group(1), 16) <= addr:
            loops.append((int(bra.group(1), 16), addr))
    innermost = [(a, b) for a, b in loops if not any(a <= c and d <= b and (c, d) != (a, b) for c, d in loops)]
    best = None
    for a, b in innermost:
        loop = [t for x, t in body if a <= x <= b and not t.startswith("NOP")]
        rcp = sum("MUFU.RCP" in t for t in loop)
        if rcp and (best is None or (rcp, -len(loop)) > (best[0], -len(best[1]))):
            best = (rcp, loop)
    if best is None:
        raise AssertionError("no innermost loop with a reciprocal (MUFU.RCP) in the kernel's SASS")
    rcp, loop = best
    opcodes = [re.sub(r"^@!?U?P\w+\s+", "", t).split()[0] for t in loop]
    return {
        "loop_instructions": len(loop),
        "reciprocals": rcp,
        "instructions_per_term": len(loop) / rcp,
        "fchk": opcodes.count("FCHK"),
        "branches": sum(o.startswith("BRA") for o in opcodes),
        "mix": {o: opcodes.count(o) for o in sorted(set(opcodes))},
    }


def lazy_series_sass(library: Path) -> dict[str, dict]:
    """series_loop_counts of the gather and materialize kernels (float32 moments)."""
    funcs = sass_functions(library)
    out = {}
    for kernel, tag in (("lazy_gather_catch_up", "gather_catch_up_kernelIffE"),
                        ("lazy_materialize", "materialize_kernelIffE")):
        names = [n for n in funcs if tag in n]
        if len(names) != 1:
            raise AssertionError(f"{kernel}: {len(names)} SASS functions named like {tag}")
        out[kernel] = series_loop_counts(funcs[names[0]])
    return out


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def forward_kernel(staged_before: int) -> str:
    """Which forward kernel the wrapper's last launch took, by the staged
    counter read before it."""
    return "staged" if session_attention.staged_launches > staged_before else "row"


def packed_rows(adj: torch.Tensor) -> torch.Tensor:
    """np.packbits of a bool adjacency's rows, on its device."""
    return torch.from_numpy(np.packbits(adj.cpu().numpy(), axis=-1)).to(adj.device)


def check_attention(B: int, N: int, gen: torch.Generator, packed: bool = False) -> dict:
    """The eval forward at [B, N], against the plain version. `packed`: the
    kernel reads the bit-packed rows [B, N, ceil(N / 8)] (a batch copied to
    the card), its bits held equal to the bool route's and both timed, the
    bound counting the adjacency bytes the route reads."""
    dev = torch.device("cuda")
    q, k, v = (torch.randn(B, N, DIM, device=dev, generator=gen) for _ in range(3))
    adj = torch.rand(B, N, N, device=dev, generator=gen) < 0.3
    adj[:, 0, :] = False  # an isolated destination in every session
    adj_read = packed_rows(adj) if packed else adj
    staged, counted = session_attention.staged_launches, session_attention.packed_launches
    got = session_attention(q, k, v, adj_read, HEADS, packed=packed)
    kernel = forward_kernel(staged)
    if session_attention.packed_launches != counted + packed:
        raise AssertionError("the packed route was not counted once")
    want = session_attention_reference(q, k, v, adj, HEADS)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **ATTN_TOL)
    if not torch.all(got[:, 0] == 0):
        raise AssertionError("isolated destinations must output exact zeros")
    if packed and not _same_bits(got, session_attention(q, k, v, adj, HEADS)):
        raise AssertionError(f"B={B} N={N}: the packed route's bits differ from the bool route's")
    err = (got - want).abs().max().item()

    d = DIM // HEADS
    qh, kh, vh = (t.view(B, N, HEADS, d).transpose(1, 2) for t in (q, k, v))
    mask = adj[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    edges = int(adj.sum())
    (bound, bound_by), _ = attention_bounds(B, N, edges, adj_bytes=adj_read.numel())
    row = {
        "shape": f"B={B} N={N} H={HEADS} d={d}" + (" adj=packed" if packed else ""),
        "kernel": kernel,
        "max_abs_err": err,
        **timings(
            lambda: session_attention(q, k, v, adj_read, HEADS, packed=packed),
            lambda: session_attention_reference(q, k, v, adj, HEADS),
            lambda: sdpa(qh, kh, vh, attn_mask=mask),
        ),
        "bound_ms": bound,
        "bound_by": bound_by,
        # what an empty kernel of the row forward's grid costs, from the same kind of graph
        "launch_floor_ms": device_ms(lambda: session_attention_launch_floor(B, N, HEADS, d)) if B == 1 else None,
    }
    if packed:
        row["bool_ms"] = device_ms(lambda: session_attention(q, k, v, adj, HEADS))
        row["bool_bound_ms"] = attention_bounds(B, N, edges)[0][0]
    return row


def check_scoring(gen: torch.Generator, B: int = 1, num_items: int = NUM_ITEMS, dim: int = DIM) -> dict:
    """B = 1 with an exclusion mask is the serving call; B = 512 without one
    is the eval step's, which is also checked once with a [B, V] mask. Full
    width unless `num_items` and `dim` say otherwise."""
    dev = torch.device("cuda")
    rows = padded_rows(num_items)
    table = torch.randn(rows, dim, device=dev, generator=gen)
    table[0] = 0.0
    table[num_items:] = 0.0
    sess = torch.randn(B, dim, device=dev, generator=gen)
    exclude = None
    if B == 1:
        exclude = torch.zeros(rows, dtype=torch.uint8, device=dev)
        exclude[torch.randint(1, num_items, (50,), device=dev, generator=gen)] = 1
        exclude[0] = 1
    got = score_chunkmax(sess, table, num_items, exclude)
    want = score_chunkmax_reference(sess, table, num_items, exclude)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **SCORE_TOL)
    finite = torch.isfinite(want[0])
    err = max((g[torch.isfinite(w)] - w[torch.isfinite(w)]).abs().max().item() for g, w in zip(got, want))
    s_got, i_got = select_topk(*got, 20)
    s_want, _ = dense_topk(sess, table, 20, num_items, exclude)
    torch.testing.assert_close(s_got, s_want, **SCORE_TOL)
    n_excluded = 0 if exclude is None else int(exclude[:num_items].sum())
    if int(finite.sum()) != B * (num_items - n_excluded):
        raise AssertionError("phantom and excluded columns must be -inf, all others finite")

    if B > 1:
        masked = torch.rand(B, rows, device=dev, generator=gen) < 0.01
        masked[B - 1, 64:96] = True  # one whole chunk excluded
        got_m = score_chunkmax(sess, table, num_items, masked)
        want_m = score_chunkmax_reference(sess, table, num_items, masked)
        torch.cuda.synchronize()
        for g, w in zip(got_m, want_m):
            torch.testing.assert_close(g, w, **SCORE_TOL)
            if not torch.equal(torch.isneginf(g), torch.isneginf(w)):
                raise AssertionError("masked and phantom columns must be -inf, and no others")
        if not bool(torch.isneginf(got_m[1][B - 1, 2])):
            raise AssertionError("a chunk with every column excluded must have a -inf max")
        del masked, got_m, want_m

    n_bytes = 4 * rows * dim + 4 * B * dim + (rows if B == 1 else 0) + B * (4 * rows + 4 * rows // 32)
    bound, bound_by = bound_ms(n_bytes, 2 * B * rows * dim)

    def library():
        scores = torch.matmul(sess, table.T)
        return scores.view(B, -1, 32).amax(-1)

    depth = dict(calls=20, reps=10, eager_reps=30 if B == 1 else 10)
    return {
        "shape": f"B={B} V={rows} D={dim}",
        "max_abs_err": err,
        **timings(
            lambda: score_chunkmax(sess, table, num_items, exclude),
            lambda: score_chunkmax_reference(sess, table, num_items, exclude),
            library,
            **depth,
        ),
        "bound_ms": bound,
        "bound_by": bound_by,
        "with_selection_eager_ms": eager_ms(
            lambda: select_topk(*score_chunkmax(sess, table, num_items, exclude), 20), depth["eager_reps"]
        ),
    }


def check_ties(gen: torch.Generator, B: int = 1) -> None:
    """Entries in {-1, 0, 1}: every score is an exact integer in any order of
    summation, so ties are massive and the kernel's top-k must EQUAL the
    stable dense top-k (lowest index first), at k = 10 and 100."""
    dev = torch.device("cuda")
    rows = 467_456
    table = torch.randint(-1, 2, (rows, DIM), device=dev, generator=gen).float()
    sess = torch.randint(-1, 2, (B, DIM), device=dev, generator=gen).float()
    full, _ = score_chunkmax_reference(sess, table, NUM_ITEMS)
    cut_tied = False
    for k in (10, 100):
        s_got, i_got = select_topk(*score_chunkmax(sess, table, NUM_ITEMS), k)
        s_want, i_want = dense_topk(sess, table, k, NUM_ITEMS)
        if not (torch.equal(i_got, i_want) and torch.equal(s_got, s_want)):
            raise AssertionError(f"tie case k={k}: kernel top-k differs from the stable dense top-k")
        # A tie across the cut: an item left out scores as much as one kept,
        # so only the lowest-index rule decides which one is in the top-k.
        last = s_want[0, -1]
        cut_tied |= int((full[0] == last).sum()) > int((s_want[0] == last).sum())
    if not cut_tied:
        raise AssertionError("tie case has no tie across the cut at any k")


def crossover_attention(gen: torch.Generator) -> list[dict]:
    """The two forward kernels inside session_attention, each named outright,
    without dropout (the serving and evaluation instance), with the kernel the
    wrapper itself chooses at that size. Device ms per call."""
    dev = torch.device("cuda")
    rows = []
    for N in BUCKETS:
        for B in (1, 8, 16, 32, 64, 128, 512):
            q, k, v = (torch.randn(B, N, DIM, device=dev, generator=gen) for _ in range(3))
            adj = torch.rand(B, N, N, device=dev, generator=gen) < 0.3
            before = session_attention.staged_launches
            session_attention(q, k, v, adj, HEADS)
            chosen = "staged" if session_attention.staged_launches > before else "warp"
            row = {"B": B, "N": N, "pairs": B * HEADS, "chosen": chosen}
            for variant in ("warp", "staged"):
                row[f"{variant}_ms"] = device_ms(
                    lambda: session_attention_variant(q, k, v, adj, HEADS, 0.0, 0, variant))
            rows.append(row)
    return rows


def crossover_scoring(gen: torch.Generator) -> list[dict]:
    """The two kernels inside score_chunkmax, each named outright, over the
    full table, with the kernel the wrapper itself chooses at that batch.
    Device ms per call; the per-session kernel's time grows with B, so its
    large batches are timed at a smaller depth."""
    dev = torch.device("cuda")
    table = torch.randn(ROWS, DIM, device=dev, generator=gen)
    rows = []
    for B in (1, 2, 4, 8, 16, 64, 512):
        sess = torch.randn(B, DIM, device=dev, generator=gen)
        before = score_chunkmax.tile_launches
        score_chunkmax(sess, table, NUM_ITEMS)
        chosen = "tile" if score_chunkmax.tile_launches > before else "warp"
        row = {"B": B, "chosen": chosen}
        for variant in ("warp", "tile"):
            depth = dict(calls=1, reps=3) if variant == "warp" and B >= 64 else dict(calls=4, reps=5)
            row[f"{variant}_ms"] = device_ms(
                lambda: score_chunkmax_variant(sess, table, NUM_ITEMS, None, variant), **depth)
        rows.append(row)
    return rows


def check_crossover(rows: list[dict], what: str, tolerance: float = 1.15) -> None:
    """The wrapper's choice must be the faster kernel at every measured size,
    or within `tolerance` of it (near the crossover the two are level)."""
    for row in rows:
        other = next(v for v in ("warp", "tile", "staged") if f"{v}_ms" in row and v != row["chosen"])
        if row[f"{row['chosen']}_ms"] > tolerance * row[f"{other}_ms"]:
            raise AssertionError(f"{what}: the wrapper chooses the slower kernel at {row}")


# ---------------------------------------------------------------------------
# Phase 4: the serving slice at full width
# ---------------------------------------------------------------------------


def make_checkpoint(path: Path) -> None:
    gen = torch.Generator().manual_seed(0)
    model = create_model("graph_transformer_optimized", NUM_ITEMS, generator=gen, device="cpu")
    with torch.no_grad():
        model.cached_pe.normal_(generator=gen)
        model.cached_pe[NUM_ITEMS:] = 0.0
        for bn in model.batch_norms:
            bn.mean.normal_(0.0, 0.3, generator=gen)
            bn.var.uniform_(0.5, 2.0, generator=gen)
            bn.scale.uniform_(0.5, 1.5, generator=gen)
            bn.bias.normal_(0.0, 0.2, generator=gen)
    checkpoint.save(path, model, epoch=0, best_val_metric=0.0)


def make_edge_arrays(rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """Random co-occurrence edges between items close in id (offset 1..64),
    canonical (min, max) like the real graph, so sessions drawn from a window
    of ids have induced edges."""
    item_i = rng.integers(1, NUM_ITEMS - 64, NUM_EDGES)
    return item_i, item_i + rng.integers(1, 65, NUM_EDGES)


def make_edges(path: Path, rng: np.random.Generator) -> None:
    np.savetxt(path, np.stack(make_edge_arrays(rng), 1), fmt="%d", delimiter=",",
               header="item_i,item_j", comments="")


def make_sessions(rng: np.random.Generator) -> list[tuple[list[int], int]]:
    """12 sessions, three per node bucket, drawn from windows of nearby ids."""
    out = []
    for n, k in zip((3, 5, 8, 9, 12, 16, 20, 27, 32, 33, 45, 50),
                    (10, 20, 5, 10, 50, 10, 100, 10, 20, 10, 15, 10)):
        start = int(rng.integers(1, NUM_ITEMS - 4 * n))
        items = rng.choice(np.arange(start, start + 2 * n), n, replace=False).tolist()
        out.append((items + items[:2], k))  # repeats do not change the bucket
    return out


def post(url: str, body: dict) -> tuple[int, dict, float]:
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(), headers={"Content-Type": "application/json"}
    )
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as r:
        payload = json.loads(r.read())
        status = r.status
    return status, payload, (time.perf_counter() - t0) * 1e3


def agree(gpu: tuple[list, list], cpu: tuple[list, list]) -> None:
    """Scores within SERVE_TOL; ids equal except where neighbouring CPU scores
    tie within that tolerance (the order of a near-tie may flip)."""
    (g_ids, g_s), (c_ids, c_s) = gpu, cpu
    if len(g_ids) != len(c_ids) or np.max(np.abs(np.subtract(g_s, c_s))) > SERVE_TOL:
        raise AssertionError(f"card and CPU scores differ: {g_s[:5]} vs {c_s[:5]}")
    for p, (a, b) in enumerate(zip(g_ids, c_ids)):
        if a != b:
            near = [c_s[q] for q in (p - 1, p + 1) if 0 <= q < len(c_s)]
            if not any(abs(c_s[p] - s) <= SERVE_TOL for s in near):
                raise AssertionError(f"id {a} vs {b} at rank {p} without a near-tie")


def serve_full_width(workdir: Path) -> dict:
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    make_checkpoint(workdir / "ckpt")
    make_edges(workdir / "graph_edges.csv", rng)
    log(f"[phase 4] checkpoint and {NUM_EDGES} edges written in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    rec = Recommender(workdir / "ckpt", workdir / "graph_edges.csv", device="cuda")
    cpu = Recommender(workdir / "ckpt", workdir / "graph_edges.csv", device="cpu", warmup=False, int8_scoring=False)
    log(f"[phase 4] recommenders loaded and warmed in {time.perf_counter() - t0:.1f} s")

    app.set_recommender(rec)
    server = app.make_server("127.0.0.1", 0, load_model=False)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/recommend"
    sessions = make_sessions(rng)
    latencies, server_ms, buckets = [], [], set()
    reset_launch_counts()
    try:
        for items, k in sessions:
            status, payload, ms = post(url, {"session_items": items, "k": k})
            ids, scores = payload.get("recommendations"), payload.get("scores")
            if status != 200 or len(ids) != k:
                raise AssertionError(f"HTTP {status} / {len(ids or [])} items for k={k}: {payload}")
            if set(ids) & set(items) or 0 in ids or max(ids) >= NUM_ITEMS:
                raise AssertionError("a seen, padding or phantom item was recommended")
            if not all(np.isfinite(scores)) or any(a < b for a, b in zip(scores, scores[1:])):
                raise AssertionError("scores must be finite and descending")
            latencies.append(ms)
            server_ms.append(payload["latency_ms"])
            buckets.add(next(b for b in BUCKETS if len(set(items)) <= b))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        app.set_recommender(None)
    launches = launch_counts()
    if buckets != set(BUCKETS):
        raise AssertionError(f"requests covered buckets {sorted(buckets)}, want {BUCKETS}")

    requests = [validate_request(_Req(items, k), NUM_ITEMS) for items, k in sessions]
    for v in requests:
        agree(rec.recommend(v), cpu.recommend(v))
    return {
        "requests": len(sessions),
        "launches": launches,
        "http_ms_p50": statistics.median(latencies),
        "http_ms_max": max(latencies),
        "server_ms_p50": statistics.median(server_ms),
        "server_ms_max": max(server_ms),
        "profile": profile_requests(rec, requests),
    }


class _Req:
    def __init__(self, items, k):
        self.session_items, self.k = items, k


def device_rows(prof) -> list:
    """The device's own operations of a torch.profiler trace, by name. A user
    annotation (``Optimizer.step#AdamW.step``) also carries a device span,
    which covers kernels already counted and the gaps between them: left out."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]


def profile_requests(rec: Recommender, requests: list) -> dict:
    """Where a request's time goes: the wall time of `Recommender.recommend`
    over the requests (unprofiled, synchronised by its own readback), and
    from a torch.profiler trace of the same requests the card's busy time
    and its kernels by device time. Idle share = 1 - busy / wall."""
    from torch.profiler import ProfilerActivity, profile

    for v in requests:
        rec.recommend(v)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for v in requests:
        rec.recommend(v)
    wall_ms = (time.perf_counter() - t0) * 1e3 / len(requests)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for v in requests:
            rec.recommend(v)
        torch.cuda.synchronize()
    rows = device_rows(prof)
    busy_us = sum(e.self_device_time_total for e in rows) / len(requests)
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:10]
    return {
        "wall_ms_per_request": wall_ms,
        "device_busy_ms_per_request": busy_us / 1e3 if rows else "not measured",
        "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms if rows else "not measured",
        "device_ops_per_request": sum(e.count for e in rows) / len(requests),
        "top_device_ms_per_request": {
            e.key[:80]: e.self_device_time_total / 1e3 / len(requests) for e in top
        },
    }


# ---------------------------------------------------------------------------
# Phase 7: the training kernels against their plain versions
# ---------------------------------------------------------------------------


def check_attention_training(B: int, N: int, dropout_p: float, gen: torch.Generator,
                             heads: int = HEADS, dim: int = DIM, packed: bool = False) -> dict:
    """Forward and backward at a train shape, `heads` heads of dim / heads.
    With dropout the kernels and the plain version draw the same keep bits
    from the same seed, so the same tolerances hold. The backward has no
    atomics: two runs must give equal bits. `packed`: the kernels read the
    bit-packed rows [B, N, ceil(N / 8)] (a batch copied to the card), their
    bits held equal to the bool route's and both timed, the bounds counting
    the adjacency bytes the route reads. Returns the forward's row and the
    backward's row."""
    dev = torch.device("cuda")
    q, k, v, dout = (torch.randn(B, N, dim, device=dev, generator=gen) for _ in range(4))
    adj = torch.rand(B, N, N, device=dev, generator=gen) < 0.3
    adj[:, 0, :] = False  # an isolated destination in every session
    adj_read = packed_rows(adj) if packed else adj
    seed = 0x5EED_0000_0000_0001 + N
    results = []
    staged = session_attention.staged_launches
    counted = (session_attention.packed_launches, session_attention.packed_backward_launches)
    for fn, fn_adj, kw in ((session_attention, adj_read, {"packed": packed}), (session_attention_reference, adj, {})):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves, fn_adj, heads, dropout_p, seed, **kw)
        results.append((out.detach(), *torch.autograd.grad(out, leaves, dout)))
    kernel = forward_kernel(staged)
    if (session_attention.packed_launches, session_attention.packed_backward_launches) != (
            counted[0] + packed, counted[1] + packed):
        raise AssertionError("the packed route was not counted once forward and once backward")
    torch.cuda.synchronize()
    torch.testing.assert_close(results[0][0], results[1][0], **ATTN_TOL)
    for got, want in zip(results[0][1:], results[1][1:]):
        torch.testing.assert_close(got, want, **ATTN_GRAD_TOL)
    if not all(torch.all(t[:, 0] == 0) for t in results[0][:2]):
        raise AssertionError("isolated destinations must give exact zeros, forward and dq")
    again = session_attention_backward(q, k, v, adj_read, dout, heads, dropout_p, seed, packed=packed)
    if not all(_same_bits(x, y) for x, y in zip(again, results[0][1:])):
        raise AssertionError("two runs of the attention backward must give equal bits")
    if packed:
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = session_attention(*leaves, adj, heads, dropout_p, seed)
        if not all(_same_bits(x, y) for x, y in
                   zip((out.detach(), *torch.autograd.grad(out, leaves, dout)), results[0])):
            raise AssertionError(f"B={B} N={N}: the packed route's bits differ from the bool route's")
    fwd_err = (results[0][0] - results[1][0]).abs().max().item()
    bwd_err = max((g - w).abs().max().item() for g, w in zip(results[0][1:], results[1][1:]))

    d = dim // heads
    shape = f"B={B} N={N} H={heads} d={d} p={dropout_p}" + (" adj=packed" if packed else "")
    edges = int(adj.sum())
    fwd_bound, bwd_bound = attention_bounds(B, N, edges, heads, dim, adj_bytes=adj_read.numel())
    fwd = {"shape": shape, "kernel": kernel, "max_abs_err": fwd_err, "bound_ms": fwd_bound[0],
           "bound_by": fwd_bound[1]}
    bwd = {"shape": shape, "max_abs_err": bwd_err, "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1]}

    qh, kh, vh, doh = (t.view(B, N, heads, d).transpose(1, 2) for t in (q, k, v, dout))
    mask = adj[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def both(fn):
        """Forward plus backward of a differentiable attention, for the versions
        that have no backward of their own to call."""
        def run():
            leaves = [t.detach().requires_grad_(True) for t in fn.inputs]
            return torch.autograd.grad(fn(*leaves), leaves, fn.grad)
        return run

    def plain(a, b, c):
        return session_attention_reference(a, b, c, adj, heads, dropout_p, seed)

    def library(a, b, c):
        return sdpa(a, b, c, attn_mask=mask, dropout_p=dropout_p)

    plain.inputs, plain.grad = (q, k, v), dout
    library.inputs, library.grad = (qh, kh, vh), doh
    held = seed_on_card(seed)
    fwd.update(timings(
        lambda: session_attention(q, k, v, adj_read, heads, dropout_p, held, packed=packed),
        lambda: plain(q, k, v),
        lambda: library(qh, kh, vh),
    ))
    both_plain, both_library = device_ms(both(plain)), device_ms(both(library))
    bwd.update({
        "ms": device_ms(lambda: session_attention_backward(q, k, v, adj_read, dout, heads, dropout_p, held,
                                                          packed=packed)),
        # the plain and library backward: forward plus backward minus the forward
        "plain_ms": both_plain - fwd["plain_ms"],
        "library_ms": both_library - fwd["library_ms"],
        "eager_ms": eager_ms(lambda: session_attention_backward(q, k, v, adj_read, dout, heads, dropout_p, held,
                                                                packed=packed)),
    })
    if packed:
        fwd_bool, bwd_bool = attention_bounds(B, N, edges, heads, dim)
        fwd.update(bool_ms=device_ms(lambda: session_attention(q, k, v, adj, heads, dropout_p, held)),
                   bool_bound_ms=fwd_bool[0])
        bwd.update(bool_ms=device_ms(lambda: session_attention_backward(q, k, v, adj, dout, heads, dropout_p,
                                                                        held)),
                   bool_bound_ms=bwd_bool[0])
    return {"forward": fwd, "backward": bwd}


def attention_bounds(B: int, N: int, edges: int, heads: int = HEADS, dim: int = DIM,
                     adj_bytes: int | None = None) -> tuple[tuple[float, str], tuple[float, str]]:
    """(forward, backward) bounds of the attention kernels for `edges` edges.
    Forward: q, k, v read, out written, adj read; two edge products (q.k and
    alpha*v) of 2*d operations each, per head. Backward: q, k, v, dO read, dq,
    dk, dv written, adj read, each once whatever the kernel reads again; five
    edge products (scores, dO.v, dV, dK, dQ). d * heads = dim whatever the
    split. `adj_bytes`: B * N * N for the bool adjacency, B * N * ceil(N / 8)
    for the packed rows."""
    d = dim // heads
    adj_bytes = B * N * N if adj_bytes is None else adj_bytes
    return (bound_ms(4 * 4 * B * N * dim + adj_bytes, 4 * d * heads * edges),
            bound_ms(7 * 4 * B * N * dim + adj_bytes, 10 * d * heads * edges))


def attention_at_adjacency(batch: SessionBatch, gen: torch.Generator) -> dict:
    """The train-mode attention kernels timed at a batch's adjacency on the
    card, in the form the trainer reads it (the packed rows), which is
    sparser than the random 0.3 of the checks above."""
    B, N = batch.batch_size, batch.nodes_per_session
    q, k, v, dout = (torch.randn(B, N, DIM, device=batch.adj.device, generator=gen) for _ in range(4))
    edges = int(batch.dense_adj().sum())
    fwd_bound, bwd_bound = attention_bounds(B, N, edges, adj_bytes=batch.adj.numel())
    seed = seed_on_card(5)
    adj, packed = batch.adj, batch.adj_packed
    return {
        "shape": f"B={B} N={N} H={HEADS} d={DIM // HEADS} p={DROPOUT}" + (" adj=packed" if packed else ""),
        "density": edges / (B * N * N),
        "forward_ms": device_ms(lambda: session_attention(q, k, v, adj, HEADS, DROPOUT, seed, packed=packed)),
        "forward_bound_ms": fwd_bound[0],
        "backward_ms": device_ms(lambda: session_attention_backward(q, k, v, adj, dout, HEADS, DROPOUT, seed,
                                                                    packed=packed)),
        "backward_bound_ms": bwd_bound[0],
        "bound_by": bwd_bound[1],
    }


def check_node_dropout(gen: torch.Generator, shape: tuple = (TRAIN_BATCH, 56, DIM)) -> dict:
    """Node dropout at `shape` (the training batch's [512, 56, 256] unless
    given), rate 0.1: the kernel, forward and backward (the same kernel on
    the output gradient), against the plain version on the same seed, EQUAL
    bit for bit (the same keep bits and the same float32 product); the kept
    share within 1e-3 of 0.9 or, at small shapes, five binomial standard
    deviations. No PyTorch call computes the same function:
    torch.nn.functional.dropout draws other bits."""
    dev = torch.device("cuda")
    x, g = (torch.randn(*shape, device=dev, generator=gen) for _ in range(2))
    seed = 0x5EED_0000_0000_0002
    results = []
    for fn in (lambda t: node_dropout(t, DROPOUT, seed), lambda t: node_dropout_reference(t, DROPOUT, True, seed)):
        leaf = x.clone().requires_grad_(True)
        out = fn(leaf)
        results.append((out.detach(), *torch.autograd.grad(out, leaf, g)))
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(*results)):
        raise AssertionError("node_dropout: the kernel differs from the plain version, forward or backward")
    kept = float((results[0][0] != 0).float().mean())
    if abs(kept - (1 - DROPOUT)) > max(1e-3, 5 * math.sqrt(DROPOUT * (1 - DROPOUT) / x.numel())):
        raise AssertionError(f"node_dropout keeps {kept} of the elements at rate {DROPOUT}")
    n = x.numel()
    bound, bound_by = bound_ms(2 * 4 * n + 8, 0, n_int_instructions=HASH_INSTRUCTIONS * n)
    held = seed_on_card(seed)
    return {
        "shape": f"{list(shape)} p={DROPOUT}",
        "max_abs_err": max((a - b).abs().max().item() for a, b in zip(*results)),
        "kept_share": kept,
        **timings(lambda: node_dropout(x, DROPOUT, held),
                  lambda: node_dropout_reference(x, DROPOUT, True, seed), None),
        "bound_ms": bound,
        "bound_by": bound_by,
    }


def _table_state(gen: torch.Generator, moment_dtype: torch.dtype, rows: int = ROWS, dim: int = DIM):
    dev = torch.device("cuda")
    table = 0.05 * torch.randn(rows, dim, device=dev, generator=gen)
    mu = (1e-3 * torch.randn(rows, dim, device=dev, generator=gen)).to(moment_dtype)
    nu = (1e-6 * torch.rand(rows, dim, device=dev, generator=gen)).to(moment_dtype)
    return table, mu, nu


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    bits = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return torch.equal(a.view(bits), b.view(bits))


def _bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit, whatever the dtype and shape (integer and 0-dim
    tensors by value)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return _same_bits(a.reshape(-1), b.reshape(-1)) if a.is_floating_point() else torch.equal(a, b)


def _fused_adamw_library(w, mu, nu, grad, prepare=None):
    """torch._fused_adamw_ on the same tensors (float32 moments only), or None
    if this PyTorch has no such call. `prepare` runs first inside the timed
    function (the sparse case scatters its rows into the dense gradient)."""
    fused = getattr(torch, "_fused_adamw_", None)
    if fused is None or mu.dtype != torch.float32 or nu.dtype != torch.float32:
        return None
    step = torch.full((), 3.0, device=w.device)

    def run():
        if prepare is not None:
            prepare()
        fused([w], [grad], [mu], [nu], [], [step], lr=ADAMW["lr"], beta1=ADAMW["b1"],
              beta2=ADAMW["b2"], weight_decay=ADAMW["weight_decay"], eps=ADAMW["eps"],
              amsgrad=False, maximize=False)

    try:
        run()
        torch.cuda.synchronize()
    except (TypeError, RuntimeError) as e:  # a private call: its signature may differ
        log(f"[phase 7] no library yardstick: torch._fused_adamw_ refused the call ({e})")
        return None
    return run


def check_sparse_adamw(gen: torch.Generator, moment_dtype: torch.dtype, stochastic: bool,
                       U: int = 16384, n_unique: int = 12000, rows: int = ROWS) -> dict:
    """Full width (`rows` rows of DIM unless given), U slots (16,384 unless
    given): n_unique unique rows (row 0 among them, its summed row zeroed as
    the train step does) and a sentinel tail."""
    dev = torch.device("cuda")
    table, mu, nu = _table_state(gen, moment_dtype, rows)
    ids = torch.randperm(min(NUM_ITEMS, rows) - 1, device=dev, generator=gen)[: n_unique - 1] + 1
    uid = torch.full((U,), 2**31 - 1, dtype=torch.int32, device=dev)
    uid[:n_unique] = torch.cat([torch.zeros(1, device=dev, dtype=torch.long), ids.sort().values]).int()
    summed = 1e-3 * torch.randn(U, DIM, device=dev, generator=gen)
    summed[0] = 0.0
    summed[n_unique:] = 0.0
    got = [t.clone() for t in (table, mu, nu)]
    want = [t.clone() for t in (table, mu, nu)]
    for count in (1, 2, 3):
        sparse_adamw(*got, uid, summed, count, stochastic_rounding=stochastic, **ADAMW)
        sparse_adamw_reference(*want, uid, summed, count, stochastic_rounding=stochastic, **ADAMW)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], **TABLE_TOL)
    if not (_same_bits(got[1], want[1]) and _same_bits(got[2], want[2])):
        raise AssertionError("sparse_adamw: the kernel's moments differ from the plain version's bits")
    if torch.equal(got[0], table):
        raise AssertionError("sparse_adamw: the table must move")
    err = (got[0] - want[0]).abs().max().item()

    m_bytes = 2 if moment_dtype == torch.bfloat16 else 4
    n_bytes = 2 * rows * DIM * (4 + 2 * m_bytes) + 4 * U + 4 * n_unique * DIM
    bound, bound_by = bound_ms(n_bytes, 14 * rows * DIM)
    grad = torch.zeros_like(table)
    touched = uid[:n_unique].long()

    def scatter():
        grad.zero_()
        grad.index_add_(0, touched, summed[:n_unique])

    row3 = step_row(3)

    return {
        "shape": f"V={rows} D={DIM} U={U} unique={n_unique} moments={str(moment_dtype).split('.')[-1]}"
                 f"{'+sr' if stochastic else ''}",
        "max_abs_err": err,
        **timings(
            lambda: sparse_adamw(*got, uid, summed, row3, stochastic_rounding=stochastic, **ADAMW),
            lambda: sparse_adamw_reference(*want, uid, summed, 3, stochastic_rounding=stochastic, **ADAMW),
            _fused_adamw_library(*[t.clone() for t in (table, mu, nu)], grad, scatter),
            calls=10, reps=5, eager_reps=10,
        ),
        "bound_ms": bound,
        "bound_by": bound_by,
    }


def check_embedding_adamw(gen: torch.Generator, moment_dtype: torch.dtype, stochastic: bool,
                          rows: int = ROWS, dim: int = DIM) -> dict:
    """The dense AdamW over a [rows, dim] table (full width unless given),
    three steps against the plain version."""
    dev = torch.device("cuda")
    table, mu, nu = _table_state(gen, moment_dtype, rows, dim)
    grad = 1e-3 * torch.randn(rows, dim, device=dev, generator=gen)
    grad[0] = 0.0
    got = [t.clone() for t in (table, mu, nu)]
    want = [t.clone() for t in (table, mu, nu)]
    for count in (1, 2, 3):
        embedding_adamw(*got, grad, count, stochastic_rounding=stochastic, **ADAMW)
        embedding_adamw_reference(*want, grad, count, stochastic_rounding=stochastic, **ADAMW)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], **TABLE_TOL)
    if not (_same_bits(got[1], want[1]) and _same_bits(got[2], want[2])):
        raise AssertionError("embedding_adamw: the kernel's moments differ from the plain version's bits")
    err = (got[0] - want[0]).abs().max().item()
    m_bytes = 2 if moment_dtype == torch.bfloat16 else 4
    n_bytes = rows * dim * (3 * 4 + 4 * m_bytes)  # w and grad read, w written; mu, nu read and written
    bound, bound_by = bound_ms(n_bytes, 16 * rows * dim)
    row3 = step_row(3)
    return {
        "shape": f"V={rows} D={dim} moments={str(moment_dtype).split('.')[-1]}{'+sr' if stochastic else ''}",
        "max_abs_err": err,
        **timings(
            lambda: embedding_adamw(*got, grad, row3, stochastic_rounding=stochastic, **ADAMW),
            lambda: embedding_adamw_reference(*want, grad, 3, stochastic_rounding=stochastic, **ADAMW),
            _fused_adamw_library(*[t.clone() for t in (table, mu, nu)], grad),
            calls=10, reps=5, eager_reps=10,
        ),
        "bound_ms": bound,
        "bound_by": bound_by,
    }


def reset_ms(fn, reset, reps: int) -> float:
    """Median CUDA-event time of one call of fn, in ms, with `reset` (not
    timed) before each call: for a kernel whose work depends on state that a
    call changes (materialize leaves every row current). One warm-up call."""
    times = []
    for _ in range(reps + 1):
        reset()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times[1:])


def tol_ratio(got: torch.Tensor, want: torch.Tensor, tol: dict = TABLE_TOL) -> float:
    """Largest |got - want| / (atol + rtol |want|): below 1 is within `tol`."""
    return ((got - want).abs() / (tol["atol"] + tol["rtol"] * want.abs())).max().item()


def max_ulp(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in units in the last place between two float32 or
    bfloat16 tensors of one sign pattern (0 where the bits are equal)."""
    bits = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return int((a.view(bits).long() - b.view(bits).long()).abs().max())


def _lazy_inputs(gen: torch.Generator, moment_dtype: torch.dtype, U: int, n_unique: int):
    """Full-width table, moments and last_step (each row LAZY_GAPS steps
    behind LAZY_COUNT - 1; one row in 16 with zero moments, as never
    touched), U slots of n_unique unique rows with row 0 and a sentinel
    tail, and their summed gradients."""
    dev = torch.device("cuda")
    table, mu, nu = _table_state(gen, moment_dtype)
    table[0], mu[0], nu[0] = 0.0, 0.0, 0.0
    mu[1::16], nu[1::16] = 0.0, 0.0  # rows never touched: the kernels skip their series
    gaps = torch.tensor(LAZY_GAPS, device=dev)
    lag = gaps[torch.randint(len(LAZY_GAPS), (ROWS,), device=dev, generator=gen)]
    last = (LAZY_COUNT - 1 - lag).clamp_min(0).int()
    ids = torch.randperm(NUM_ITEMS - 1, device=dev, generator=gen)[: n_unique - 1] + 1
    uid = torch.full((U,), 2**31 - 1, dtype=torch.int32, device=dev)
    uid[:n_unique] = torch.cat([torch.zeros(1, device=dev, dtype=torch.long), ids.sort().values]).int()
    summed = 1e-3 * torch.randn(U, DIM, device=dev, generator=gen)
    summed[0] = 0.0
    summed[n_unique:] = 0.0
    return (table, mu, nu, last), uid, summed, n_unique


def series_bounds(n_bytes: float, element_terms: int, sass: dict) -> dict:
    """A lazy series kernel's bound from this run's bytes and element-terms:
    the instructions counted in its compiled loop and one reciprocal an
    element and term; beside it the earlier bound of the series with an IEEE
    division (SERIES_INSTRUCTIONS_IEEE_DIVISION)."""
    bound, bound_by = bound_ms(n_bytes, 0, sass["instructions_per_term"] * element_terms, n_mufu=element_terms)
    return {"bound_ms": bound, "bound_by": bound_by, "element_terms": element_terms,
            "instructions_per_term": sass["instructions_per_term"],
            "bound_ms_ieee_division": bound_ms(n_bytes, 0, SERIES_INSTRUCTIONS_IEEE_DIVISION * element_terms)[0]}


def check_lazy_kernels(gen: torch.Generator, moment_dtype: torch.dtype, stochastic: bool, sass: dict,
                       U: int = 16384, n_unique: int = 12000) -> dict:
    """The three lazy AdamW kernels against their plain versions at full
    width, U slots of n_unique unique rows (16,384 and 12,000 unless given):
    weights TABLE_TOL; moments and last_step equal (float32 moments:
    expf against torch's CUDA exp, measured in ulp); rows outside uid
    bit-unchanged; sentinel slots zero. Times as for the other AdamW kernels;
    materialize, whose work a call uses up, from single calls with the state
    restored before each. `sass`: lazy_series_sass of the built library."""
    state, uid, summed, n_unique = _lazy_inputs(gen, moment_dtype, U, n_unique)
    table, mu, nu, last = state
    row = step_row(LAZY_COUNT)
    label = f"moments={str(moment_dtype).split('.')[-1]}{'+sr' if stochastic else ''}"
    m_bytes = 2 if moment_dtype == torch.bfloat16 else 4
    row_bytes = DIM * (4 + 2 * m_bytes)  # a table row and its two moments
    rows = {}

    # Gather and catch-up.
    got = gather_catch_up(*state, uid, LAZY_COUNT, **ADAMW)
    want = gather_catch_up_reference(*state, uid, LAZY_COUNT, **ADAMW)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], **TABLE_TOL)
    ulp = max(max_ulp(got[1], want[1]), max_ulp(got[2], want[2]))
    if ulp:
        raise AssertionError(f"lazy_gather_catch_up: moments differ from the plain version's by {ulp} ulp")
    if not all(torch.all(t[n_unique:] == 0) for t in got):
        raise AssertionError("lazy_gather_catch_up: sentinel slots must hold zeros")
    real = uid[:n_unique].long()
    terms = (LAZY_COUNT - 1 - last[real]).clamp(0, 64)
    # The series' element-terms: elements whose mu is not 0 (a zero mu adds
    # nothing; a lane of eight zeros skips the series) times the row's terms.
    live = (mu != 0).sum(1)
    bounds = series_bounds(n_unique * (row_bytes + 4) + 4 * uid.numel() + 3 * 4 * uid.numel() * DIM,
                           int((terms * live[real]).sum()), sass["lazy_gather_catch_up"])
    rows["lazy_gather_catch_up"] = {
        "shape": f"V={ROWS} D={DIM} U={uid.numel()} unique={n_unique} {label}",
        "max_abs_err": (got[0] - want[0]).abs().max().item(), "tol_ratio": tol_ratio(got[0], want[0]),
        "moment_max_ulp": ulp, "terms_mean": terms.float().mean().item(),
        **timings(lambda: gather_catch_up(*state, uid, row, **ADAMW),
                  lambda: gather_catch_up_reference(*state, uid, LAZY_COUNT, **ADAMW), None,
                  calls=10, reps=5, eager_reps=10),
        **bounds,
    }

    # Touched update and scatter, on copies.
    kern = [t.clone() for t in state]
    plain = [t.clone() for t in state]
    touched_update_scatter(*kern, uid, *got, summed, LAZY_COUNT, stochastic_rounding=stochastic, **ADAMW)
    touched_update_scatter_reference(*plain, uid, *got, summed, LAZY_COUNT, stochastic_rounding=stochastic,
                                     **ADAMW)
    torch.cuda.synchronize()
    torch.testing.assert_close(kern[0], plain[0], **TABLE_TOL)
    if not all(_same_bits(a, b) for a, b in zip(kern[1:], plain[1:])):
        raise AssertionError("lazy_touched_update: moments or last_step differ from the plain version's")
    outside = torch.ones(ROWS, dtype=torch.bool, device=table.device)
    outside[real] = False
    if not all(_same_bits(a[outside], b[outside]) for a, b in zip(kern, state)):
        raise AssertionError("lazy_touched_update: a row outside uid changed")
    if not bool(torch.all(kern[3][real] == LAZY_COUNT)):
        raise AssertionError("lazy_touched_update: last_step of the uid rows must be the count")
    bound, bound_by = bound_ms(n_unique * (4 * 4 * DIM + row_bytes + 4) + 4 * uid.numel(), 16 * DIM * n_unique)
    rows["lazy_touched_update"] = {
        "shape": f"V={ROWS} D={DIM} U={uid.numel()} unique={n_unique} {label}",
        "max_abs_err": (kern[0] - plain[0]).abs().max().item(),
        **timings(lambda: touched_update_scatter(*kern, uid, *got, summed, row,
                                                 stochastic_rounding=stochastic, **ADAMW),
                  lambda: touched_update_scatter_reference(*plain, uid, *got, summed, LAZY_COUNT,
                                                           stochastic_rounding=stochastic, **ADAMW),
                  None, calls=10, reps=5, eager_reps=10),
        "bound_ms": bound, "bound_by": bound_by,
    }
    del plain, got, want

    # Materialize every row to LAZY_COUNT, on copies.
    kern = [t.clone() for t in state]
    plain = [t.clone() for t in state]
    materialize(*kern, LAZY_COUNT, stochastic_rounding=stochastic, **ADAMW)
    materialize_reference(*plain, LAZY_COUNT, stochastic_rounding=stochastic, **ADAMW)
    torch.cuda.synchronize()
    torch.testing.assert_close(kern[0], plain[0], **TABLE_TOL)
    ulp = max(max_ulp(kern[1], plain[1]), max_ulp(kern[2], plain[2]))
    if ulp or not torch.equal(kern[3], plain[3]) or not bool(torch.all(kern[3] == LAZY_COUNT)):
        raise AssertionError(f"lazy_materialize: moments ({ulp} ulp) or last_step differ from the plain version's")
    err, ratio = (kern[0] - plain[0]).abs().max().item(), tol_ratio(kern[0], plain[0])
    del plain
    lag = (LAZY_COUNT - last).clamp_min(0)
    behind = int((lag > 0).sum())
    bounds = series_bounds(2 * behind * row_bytes + 2 * 4 * ROWS, int((lag.clamp_max(64) * live).sum()),
                           sass["lazy_materialize"])

    def restore():
        for dst, src in zip(kern, state):
            dst.copy_(src)

    rows["lazy_materialize"] = {
        "shape": f"V={ROWS} D={DIM} rows_behind={behind} {label}",
        "max_abs_err": err, "tol_ratio": ratio, "moment_max_ulp": ulp,
        "terms_mean": lag.clamp_max(64).float().mean().item(),
        "ms": reset_ms(lambda: materialize(*kern, LAZY_COUNT, stochastic_rounding=stochastic, **ADAMW),
                       restore, reps=10),
        "plain_ms": reset_ms(lambda: materialize_reference(*kern, LAZY_COUNT, stochastic_rounding=stochastic,
                                                           **ADAMW), restore, reps=2),
        "library_ms": None,
        **bounds,
    }
    return rows


# ---------------------------------------------------------------------------
# Phase 8: the training slice at full width
# ---------------------------------------------------------------------------


def make_dataset(rng: np.random.Generator, sessions: int = NUM_SESSIONS) -> SessionDataset:
    """Seeded synthetic sessions: heavy small-session skew (geometric lengths,
    3..50 events) plus some long ones so that every node bucket fills, items
    drawn from a window of nearby ids so that the graph's edges are induced."""
    lengths = np.clip(rng.geometric(0.25, sessions) + 2, 3, 50)
    lengths[: sessions // 4] = rng.integers(12, 51, sessions // 4)
    total = int(lengths.sum())
    sid = np.repeat(np.arange(sessions), lengths)
    start = np.repeat(rng.integers(1, NUM_ITEMS - 200, sessions), lengths)
    items = start + rng.integers(0, 120, total)
    return SessionDataset(
        (sid, np.arange(total), items), make_edge_arrays(rng),
        num_negatives=NEGATIVES, num_items=NUM_ITEMS,
    )


# The state of each model the phases build from seed 0, drawn once on the CPU
# and loaded into every later build of it, on either device: a full-width
# table is 119.5 M numbers drawn by one host thread (about 0.8 s), and the
# phases build the same model dozens of times. create_model's draw on the card
# is the same bits (phase 12, seeded_weights_on_card_and_cpu).
_SEEDED_STATES: dict = {}


def make_seeded_model(name: str, fields: dict, dropout: float, device=None):
    """A model of the registry at full width (each factory's defaults but
    `fields`) from seed 0 of a CPU generator, with random positional
    encodings drawn next from it where the model has them; on the card unless
    told otherwise."""
    key = (name, tuple(sorted(fields.items())))
    if key not in _SEEDED_STATES:
        gen = torch.Generator().manual_seed(0)
        model = create_model(name, NUM_ITEMS, device="cpu", generator=gen, **fields)
        if model.uses_laplacian_pe:
            with torch.no_grad():
                model.cached_pe.normal_(generator=gen)
                model.cached_pe[NUM_ITEMS:] = 0.0
        _SEEDED_STATES[key] = model.state_dict()
    model = create_model(name, NUM_ITEMS, dropout=dropout, device="meta", **fields)
    model.to_empty(device="cuda" if device is None else device)
    model.load_state_dict(_SEEDED_STATES[key])
    return model


def make_training_model(dropout: float, device=None):
    """The optimized Graph Transformer at full width, seeded; on the card unless told otherwise."""
    return make_seeded_model("graph_transformer_optimized", {}, dropout, device)


def launch_counts() -> dict:
    """Every wrapper's launches, and of those the ones that went to the batch
    kernels (the staged attention forward, the tiled scoring product)."""
    return {
        "session_attention": session_attention.launches,
        "session_attention_staged": session_attention.staged_launches,
        "session_attention_backward": session_attention.backward_launches,
        "session_attention_packed": session_attention.packed_launches,
        "session_attention_backward_packed": session_attention.packed_backward_launches,
        "score_chunkmax": score_chunkmax.launches,
        "score_chunkmax_tile": score_chunkmax.tile_launches,
        "sparse_adamw": sparse_adamw.launches,
        "sharded_sparse_adamw": sharded_sparse_adamw.launches,
        "embedding_adamw": embedding_adamw.launches,
        "lazy_gather_catch_up": gather_catch_up.launches,
        "lazy_touched_update": touched_update_scatter.launches,
        "lazy_materialize": materialize.launches,
        "node_dropout": node_dropout.launches,
    }


def reset_launch_counts() -> None:
    session_attention.launches = session_attention.staged_launches = 0
    session_attention.backward_launches = 0
    session_attention.packed_launches = session_attention.packed_backward_launches = 0
    score_chunkmax.launches = score_chunkmax.tile_launches = 0
    sparse_adamw.launches = sharded_sparse_adamw.launches = embedding_adamw.launches = 0
    gather_catch_up.launches = touched_update_scatter.launches = materialize.launches = 0
    node_dropout.launches = 0


def expect_counts(what: str, **want) -> dict:
    """The wrappers' counts equal `want` (0 where not named); which of a
    wrapper's two kernels ran (the *_staged and *_tile counts) and which
    adjacency kernel 1 read (the *_packed counts) are not held."""
    got = launch_counts()
    want = {**{k: 0 for k in got if not k.endswith(("_staged", "_tile", "_packed"))}, **want}
    if {k: got[k] for k in want} != want:
        raise AssertionError(f"{what}: launch counts {got}, want {want}")
    return got


def expect_launches(what: str, **want) -> dict:
    """expect_counts, and at the train batch every attention forward must be
    a staged one and every scoring launch a tiled one."""
    got = expect_counts(what, **want)
    if got["session_attention_staged"] != got["session_attention"] or \
            got["score_chunkmax_tile"] != got["score_chunkmax"]:
        raise AssertionError(f"{what}: not every launch took the batch kernel: {got}")
    return got


def near_tie_agree(got, want, tol: float) -> None:
    """Top-k (scores, ids) of two exact selectors: scores within tol; ids equal
    except where neighbouring oracle scores tie within tol."""
    (g_s, g_i), (w_s, w_i) = got, want
    if (g_s - w_s).abs().max().item() > tol:
        raise AssertionError("eval top-k scores differ from the dense oracle's")
    gap = (w_s[:, :-1] - w_s[:, 1:]).abs() <= tol
    pad = torch.zeros_like(gap[:, :1])
    tied = torch.cat([gap, pad], 1) | torch.cat([pad, gap], 1)
    if bool(((g_i != w_i) & ~tied).any()):
        raise AssertionError("eval top-k ids differ from the dense oracle's without a near-tie")


def training_batches() -> tuple[dict, list]:
    """The seeded corpus's batches of 512 by node bucket, and the six that
    make a training epoch here (one of every bucket, two more)."""
    rng = np.random.default_rng(1)
    t0 = time.perf_counter()
    dataset = make_dataset(rng)
    batches = list(iterate_batches(dataset, TRAIN_BATCH, shuffle=True, seed=0))
    by_bucket = {n: [b for b in batches if b.nodes_per_session == n] for n in BUCKETS}
    if not all(by_bucket.values()):
        raise AssertionError(f"batches cover buckets {[n for n in BUCKETS if by_bucket[n]]}, want {BUCKETS}")
    log(f"[phase 8] {len(dataset)} sessions, {len(batches)} batches of {TRAIN_BATCH} "
        f"({ {n: len(v) for n, v in by_bucket.items()} }) assembled in {time.perf_counter() - t0:.1f} s")
    return by_bucket, [by_bucket[n][0] for n in BUCKETS] + [by_bucket[8][-1], by_bucket[16][-1]]


def train_full_width(by_bucket: dict, epoch: list) -> dict:
    """The eager sparse and the dense paths (lazy=False)."""
    dev = torch.device("cuda")
    loss_fn = create_loss_function("dual")
    model = make_training_model(DROPOUT)
    torch.cuda.synchronize()

    # The counted main path: Trainer epoch (sparse), repeated-batch steps, dense
    # Trainer epoch, evaluation.
    reset_launch_counts()
    trainer = Trainer(model, lambda e: iter(epoch), lambda: iter([by_bucket[56][0]]),
                      loss_fn=loss_fn, seed=7, sparse_embedding_grads=True)
    opt_state = trainer.init_state(reset_parameters=False)
    t0 = time.perf_counter()
    epoch_loss = trainer.train_epoch()
    epoch_s = time.perf_counter() - t0
    if not np.isfinite(epoch_loss):
        raise AssertionError(f"sparse epoch loss {epoch_loss}")
    n_sparse = len(epoch)
    expect_launches("sparse Trainer epoch", session_attention=2 * n_sparse,
                    session_attention_backward=2 * n_sparse, sparse_adamw=n_sparse,
                    node_dropout=4 * n_sparse)

    step = make_sparse_train_step(model, loss_fn, trainer.optimizer, opt_state)
    repeated = to_device((by_bucket[16][0], make_grad_index(by_bucket[16][0])), dev)
    losses = [step(repeated, seed=100 + i).item() for i in range(6)]
    if not all(np.isfinite(losses)) or not losses[5] < losses[0]:
        raise AssertionError(f"repeated-batch losses must be finite and fall: {losses}")
    n_sparse += 6
    expect_launches("sparse steps", session_attention=2 * n_sparse,
                    session_attention_backward=2 * n_sparse, sparse_adamw=n_sparse,
                    node_dropout=4 * n_sparse)

    dense = Trainer(model, lambda e: iter([by_bucket[8][0], by_bucket[56][0]]), lambda: iter(()),
                    optimizer=trainer.optimizer, loss_fn=loss_fn, seed=7)
    dense.init_state(reset_parameters=False, opt_state=opt_state)  # the same moments and count
    dense_loss = dense.train_epoch()
    if not np.isfinite(dense_loss) or opt_state["count"] != n_sparse + 2:
        raise AssertionError(f"dense epoch loss {dense_loss}, count {opt_state['count']}")
    expect_launches("sparse and dense steps", session_attention=2 * (n_sparse + 2),
                    session_attention_backward=2 * (n_sparse + 2), sparse_adamw=n_sparse,
                    embedding_adamw=2, node_dropout=4 * (n_sparse + 2))

    metrics = trainer.evaluate()
    if set(metrics) != {"recall@10", "ndcg@10", "recall@20", "ndcg@20"} or not all(
        np.isfinite(v) and 0.0 <= v <= 1.0 for v in metrics.values()
    ):
        raise AssertionError(f"evaluate: {metrics}")
    launches = expect_launches(
        "training and one eval batch", session_attention=2 * (n_sparse + 2) + 2,
        session_attention_backward=2 * (n_sparse + 2), sparse_adamw=n_sparse, embedding_adamw=2,
        score_chunkmax=1, node_dropout=4 * (n_sparse + 2))

    # Outside the counted path: the eval step against the dense oracle.
    eval_batch = to_device(by_bucket[56][0], dev)
    ids = make_eval_step(model, 20)(eval_batch)
    with torch.no_grad():
        sess = model.eval()(eval_batch)
        table = model.item_embedding
        two_level = full_catalog_topk(sess, table, 20, NUM_ITEMS)
        oracle = dense_topk(sess, table, 20, NUM_ITEMS)
    if not torch.equal(ids, two_level[1]) or ids.shape != (TRAIN_BATCH, 20):
        raise AssertionError("eval step ids differ from full_catalog_topk's")
    near_tie_agree(two_level, oracle, tol=1e-6)
    if not (bool(torch.isfinite(sess).all()) and int(ids.min()) >= 0 and int(ids.max()) < NUM_ITEMS):
        raise AssertionError("eval: session embeddings must be finite, ids inside the catalog")

    return {
        "sparse_steps": n_sparse, "dense_steps": 2, "eval_batches": 1,
        "launches": launches,
        "epoch_loss": epoch_loss, "repeated_batch_losses": losses, "dense_loss": dense_loss,
        "metrics": metrics,
        "sparse_epoch_wall_ms_per_step": epoch_s * 1e3 / len(epoch),
        "cpu_copy": compare_with_cpu_copy([by_bucket[16][0], by_bucket[56][0]], loss_fn),
        "profile": profile_training(model, loss_fn, trainer.optimizer, opt_state, by_bucket, epoch),
    }


def compare_with_cpu_copy(batches: list, loss_fn, lazy: bool = False) -> dict:
    """Dropout 0: two sparse steps on the card against the same steps of a CPU
    copy of the port (the plain versions), from the same weights; with the
    lazy optimizer also last_step equal."""
    card = make_training_model(0.0)
    cpu = make_training_model(0.0, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    out = {"loss_diff": 0.0, "row_diff_max": 0.0, "row_diff_q9999": 0.0, "bn_diff": 0.0}
    steps, states = [], []
    for model in (card, cpu):
        opt = FusedEmbeddingAdamW(1e-3, weight_decay=1e-5, lazy=lazy)
        states.append(opt.init(model))
        steps.append(make_sparse_train_step(model, loss_fn, opt, states[-1]))
    for i, batch in enumerate(batches):
        gidx = make_grad_index(batch)
        device = next(card.parameters()).device
        got = steps[0](to_device((batch, gidx), device), seed=i).item()
        want = steps[1]((batch, to_device(gidx, "cpu")), seed=i).item()
        rows = torch.from_numpy(gidx.uid[gidx.uid != 2**31 - 1].astype(np.int64))
        out["loss_diff"] = max(out["loss_diff"], abs(got - want))
        diff = (
            card.item_embedding.detach()[rows.to(device)].cpu() - cpu.item_embedding.detach()[rows]
        ).abs().flatten()
        q9999 = diff.kthvalue(max(1, int(0.9999 * diff.numel()))).values.item()
        out["row_diff_max"] = max(out["row_diff_max"], diff.max().item())
        out["row_diff_q9999"] = max(out["row_diff_q9999"], q9999)
    for a, b in zip(card.batch_norms, cpu.batch_norms):
        for name in ("mean", "var"):
            out["bn_diff"] = max(out["bn_diff"], (getattr(a, name).cpu() - getattr(b, name)).abs().max().item())
    if (out["loss_diff"] > TRAIN_LOSS_TOL or out["row_diff_q9999"] > TRAIN_ROW_TOL
            or out["row_diff_max"] > TRAIN_ROW_CAP or out["bn_diff"] > TRAIN_ROW_TOL):
        raise AssertionError(f"card and CPU copy of the train step differ: {out}")
    if lazy and not torch.equal(states[0]["last_step"].cpu(), states[1]["last_step"]):
        raise AssertionError("card and CPU copy of the lazy step differ in last_step")
    return out


# The zoo's card-against-CPU check. Each of two lazy steps starts from the
# card copy's state, copied into the CPU copy (weights, buffers, moments,
# last_step), and compares that one step.
#
# A function whose gradient switches at a threshold (ReLU and LeakyReLU at 0,
# the max aggregator's choice of source) sends the whole gradient one way or
# the other where its input lies within rounding of the threshold, and the two
# copies may then take different sides: one such ReLU at GraphSAGE's last
# layer changes the gradient of every row of its session. The CPU copy takes
# the card's side of every switch (the card's x > 0, the card's winning
# sources), and the check counts the switches whose sides differed.
#
# Then every entry of the summed row gradient agrees within ZOO_GRAD_TOL
# (relative, and absolute in units of its row's rms). A row's first AdamW
# step still moves each entry by about lr * sign(gradient), so an entry whose
# gradient the copies round to opposite signs (which the gradient check puts
# within its absolute tolerance of zero) parts by up to 2 lr: such entries are
# held to 2 lr, and every other entry holds TRAIN_ROW_TOL at the 99.99th
# percentile and TRAIN_ROW_CAP at most, as the optimized model's rows do.
ZOO_GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
MAX_FILL = -1e30  # the max aggregator's fill for non-sources (models/layers.py)


class _RecordingAdamW(FusedEmbeddingAdamW):
    """The lazy optimizer, keeping the summed row gradients [U, D] of its
    last sparse update (what the touched update was given)."""

    def update_sparse_lazy(self, g_rest, uid, summed, *args, **kwargs):
        self.summed = summed.detach().clone()
        return super().update_sparse_lazy(g_rest, uid, summed, *args, **kwargs)


@contextlib.contextmanager
def _switch_sides(sides: list, counts: dict | None = None, node_mask: torch.Tensor | None = None):
    """Within: torch.relu and torch.nn.functional.leaky_relu append their sides
    (x > 0, on the CPU) to `sides` when `counts` is None; else they take their
    sides from `sides` in call order, counting in `counts` the entries whose
    side differs from their own input's, all and those of valid nodes
    (`node_mask` [B, N]; a [B, N, D] input's nodes, a [B, H, N, N] one's
    node pairs)."""
    relu, leaky_relu = torch.relu, torch.nn.functional.leaky_relu

    def side(x):
        if counts is None:
            sides.append((x > 0).cpu())
            return None
        given = sides.pop(0).to(x.device)
        differ = given != (x > 0)
        valid = node_mask[..., None] if x.dim() == 3 else node_mask[:, None, :, None] & node_mask[:, None, None, :]
        counts["switches"] += given.numel()
        counts["differ"] += int(differ.sum())
        counts["differ_on_nodes"] += int((differ & valid).sum())
        return given

    def relu_at(x):
        given = side(x)
        return relu(x) if given is None else torch.where(given, x, 0.0)

    def leaky_relu_at(x, negative_slope=0.01, inplace=False):
        given = side(x)
        return leaky_relu(x, negative_slope) if given is None else torch.where(given, x, negative_slope * x)

    torch.relu, torch.nn.functional.leaky_relu = relu_at, leaky_relu_at
    try:
        yield
    finally:
        torch.relu, torch.nn.functional.leaky_relu = relu, leaky_relu


def _max_winners(x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
    """[B, dst, src, D] bool: the sources that hold each destination's maximum,
    feature by feature (none for a destination without sources). The max
    aggregator's gradient goes to them, split evenly among equal values."""
    filled = torch.where(adj[..., None], x[:, None, :, :], MAX_FILL)
    return (filled == filled.amax(dim=2, keepdim=True)) & adj[..., None]


def _route_as(conv, winners: list, counts: dict) -> None:
    """GraphSAGE-max's `conv` takes its routing from `winners` (one
    [B, dst, src, D] per call, in call order): the mean over the given
    winners, which is the maximum's value up to rounding and sends the
    gradient where the amax sent it on the card. Counts the decisions
    (destination with sources, feature) whose winners differ from its own."""

    def forward(x, adj):
        given, own = winners.pop(0), _max_winners(x, adj)
        has_sources = adj.any(dim=-1, keepdim=True)
        counts["decisions"] += int(has_sources.sum()) * x.shape[-1]
        counts["differ"] += int((given != own).any(dim=2).sum())
        w = given.to(x.dtype)
        agg = (x[:, None, :, :] * w).sum(dim=2) / w.sum(dim=2).clamp_min(1.0)
        return conv.lin_l(torch.where(has_sources, agg, 0.0)) + conv.lin_r(x)

    conv.forward = forward


def zoo_against_cpu_copy(batches: list, loss_fn, make, max_aggregator: bool = False) -> dict:
    """Dropout 0: lazy sparse steps of a zoo model (`make(dropout, device=None)`)
    on the card against a CPU copy of the port (the plain versions), each step
    from the card's state and on the card's side of every switch, as
    ZOO_GRAD_TOL's note says. Logs the switches and routing decisions that
    differed and the entries whose gradient signs differed."""
    lr = 1e-3
    card, cpu = make(0.0), make(0.0, device="cpu")
    opts = [_RecordingAdamW(lr, weight_decay=1e-5, lazy=True) for _ in range(2)]
    states = [opt.init(model) for opt, model in zip(opts, (card, cpu))]
    steps = [make_sparse_train_step(m, loss_fn, o, s) for m, o, s in zip((card, cpu), opts, states)]
    out = {"steps": len(batches), "loss_diff": 0.0, "grad_err": 0.0, "grad_err_q9999": 0.0, "entries": 0,
           "sign_differs": 0, "sign_differs_grad_max": 0.0, "sign_differs_row_diff_max": 0.0,
           "row_diff_q9999": 0.0, "row_diff_max": 0.0, "bn_diff": 0.0}
    switches, routing = {"switches": 0, "differ": 0, "differ_on_nodes": 0}, {"decisions": 0, "differ": 0}
    ok = True
    for i, batch in enumerate(batches):
        cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
        for key in ("emb_mu", "emb_nu", "last_step"):
            states[1][key].copy_(states[0][key])
        gidx = make_grad_index(batch)
        sides, winners = [], []
        hooks = [conv.register_forward_hook(lambda m, inp, o: winners.append(_max_winners(*inp).cpu()))
                 for conv in card.convs] if max_aggregator else []
        with _switch_sides(sides):
            got = steps[0](to_device((batch, gidx), "cuda"), seed=i).item()
        for hook in hooks:
            hook.remove()
        for conv in cpu.convs if max_aggregator else ():
            _route_as(conv, winners, routing)
        with _switch_sides(sides, switches, batch.node_mask.bool()):
            want = steps[1]((batch, to_device(gidx, "cpu")), seed=i).item()
        for conv in cpu.convs if max_aggregator else ():
            del conv.forward
        valid = torch.from_numpy(gidx.uid != 2**31 - 1)
        rows = torch.from_numpy(gidx.uid[gidx.uid != 2**31 - 1].astype(np.int64))
        g_card, g_cpu = opts[0].summed.cpu()[valid], opts[1].summed[valid]
        rms = g_cpu.square().mean(dim=1, keepdim=True).sqrt()
        dg = (g_card - g_cpu).abs()
        allowed = ZOO_GRAD_TOL["rtol"] * g_cpu.abs() + ZOO_GRAD_TOL["atol"] * rms
        ratio = torch.where(dg == 0, 0.0, dg / allowed).flatten()
        apart = torch.sign(g_card) != torch.sign(g_cpu)
        diff = (card.item_embedding.detach()[rows.cuda()].cpu() - cpu.item_embedding.detach()[rows]).abs()
        held = diff[~apart]
        out["loss_diff"] = max(out["loss_diff"], abs(got - want))
        out["grad_err"] = max(out["grad_err"], ratio.max().item())
        out["grad_err_q9999"] = max(out["grad_err_q9999"],
                                    ratio.kthvalue(max(1, int(0.9999 * ratio.numel()))).values.item())
        out["entries"] += diff.numel()
        out["sign_differs"] += int(apart.sum())
        if apart.any():
            out["sign_differs_grad_max"] = max(out["sign_differs_grad_max"], (g_cpu.abs() / rms)[apart].max().item())
            out["sign_differs_row_diff_max"] = max(out["sign_differs_row_diff_max"], diff[apart].max().item())
        out["row_diff_q9999"] = max(out["row_diff_q9999"],
                                    held.kthvalue(max(1, int(0.9999 * held.numel()))).values.item())
        out["row_diff_max"] = max(out["row_diff_max"], held.max().item())
        for a, b in zip(card.batch_norms, cpu.batch_norms):
            for name in ("mean", "var"):
                out["bn_diff"] = max(out["bn_diff"], (getattr(a, name).cpu() - getattr(b, name)).abs().max().item())
        ok &= torch.equal(states[0]["last_step"].cpu(), states[1]["last_step"])
    out["sign_differs_share"] = out["sign_differs"] / out["entries"]
    out["switches"], out["switches_differ"] = switches["switches"], switches["differ"]
    out["switches_differ_on_nodes"] = switches["differ_on_nodes"]
    if max_aggregator:
        out["routing_decisions"], out["routing_differs"] = routing["decisions"], routing["differ"]
    if (not ok or out["loss_diff"] > TRAIN_LOSS_TOL or out["grad_err"] > 1.0
            or out["row_diff_q9999"] > TRAIN_ROW_TOL or out["row_diff_max"] > TRAIN_ROW_CAP
            or out["sign_differs_row_diff_max"] > 2 * lr + TRAIN_ROW_TOL or out["bn_diff"] > TRAIN_ROW_TOL):
        raise AssertionError(f"card and CPU copy of the lazy step differ (last_step equal: {ok}): {out}")
    return out


def train_lazy_full_width(by_bucket: dict, epoch: list, workdir: Path) -> dict:
    """The main training path: Trainer.train() with the lazy optimizer at full
    width (dropout 0.1, batch 512, an epoch of the six batches of the eager
    Trainer epoch, one evaluated batch, checkpoints into `workdir`). Counted:
    an uninterrupted 3-epoch run, evaluation every epoch. Then a 2-epoch run
    resumed to epoch 3 must give the same train losses (RESUME_LOSS_RTOL) and
    equal metrics; a Recommender serves a request from the best checkpoint;
    two lazy steps match a CPU copy of the port; six lazy and six eager steps
    agree after materialize (LAZY_TABLE_TOL)."""
    loss_fn = create_loss_function("dual")
    val = [by_bucket[56][0]]

    def trainer(out: str, max_epochs: int) -> Trainer:
        # checkpoint_every = 3: the latest checkpoint at the last epoch only.
        return Trainer(make_training_model(DROPOUT), lambda e: iter(epoch), lambda: iter(val),
                       optimizer=FusedEmbeddingAdamW(1e-3, weight_decay=1e-5, lazy=True),
                       output_dir=workdir / out, max_epochs=max_epochs, eval_every=1,
                       checkpoint_every=3, loss_fn=loss_fn, seed=7, sparse_embedding_grads=True)

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    straight = trainer("straight", 3)
    want = straight.train()
    wall_s = time.perf_counter() - t0
    n_steps, n_evals = 3 * len(epoch), 3
    launches = expect_launches(
        "lazy Trainer.train()", session_attention=2 * (n_steps + n_evals),
        session_attention_backward=2 * n_steps, score_chunkmax=n_evals,
        lazy_gather_catch_up=n_steps, lazy_touched_update=n_steps, lazy_materialize=n_evals,
        node_dropout=4 * n_steps)
    if straight.opt_state["count"] != n_steps or not bool(torch.all(straight.opt_state["last_step"] == n_steps)):
        raise AssertionError("after train() the lazy state must be materialized at the step count")
    if not all(np.isfinite(want["train_loss"])) or len(want["val_metrics"]) != 3:
        raise AssertionError(f"lazy train(): {want}")
    log_entries = list(straight.checkpoint_log)
    del straight
    torch.cuda.empty_cache()

    trainer("resumed", 2).train()
    resumed = trainer("resumed", 3)
    got = resumed.train(resume=True)
    log_entries += resumed.checkpoint_log
    loss_rel = float(np.max(np.abs(np.subtract(got["train_loss"], want["train_loss"]))
                            / np.abs(want["train_loss"])))
    if loss_rel > RESUME_LOSS_RTOL or got["val_metrics"] != want["val_metrics"]:
        raise AssertionError(f"resumed run differs from the uninterrupted one: {got} vs {want}")
    del resumed
    torch.cuda.empty_cache()

    # The checkpoint that train() wrote serves through the Recommender as it is.
    make_edges(workdir / "graph_edges.csv", np.random.default_rng(0))
    rec = Recommender(workdir / "straight" / "checkpoint_best", workdir / "graph_edges.csv", warmup=False)
    items = [int(i) for i in val[0].node_ids[0, : int(val[0].num_nodes[0])]]
    ids, scores = rec.recommend(validate_request(_Req(items, 10), NUM_ITEMS))
    if len(ids) != 10 or set(ids) & set(items) or not all(np.isfinite(scores)):
        raise AssertionError(f"Recommender on the lazy best checkpoint: {ids} {scores}")
    del rec

    pair = [by_bucket[16][0], by_bucket[56][0]]
    return {
        "steps": n_steps, "evaluations": n_evals, "launches": launches,
        "train_loss": want["train_loss"], "val_metrics": want["val_metrics"],
        "train_wall_s": wall_s, "resume_loss_rel_diff_max": loss_rel,
        "checkpoints": log_entries,
        "cpu_copy": compare_with_cpu_copy(pair, loss_fn, lazy=True),
        "lazy_vs_eager": lazy_against_eager(pair, loss_fn),
    }


def lazy_against_eager(batches: list, loss_fn) -> dict:
    """Dropout 0: six lazy and six eager sparse steps from the same weights
    over two batches in turn (catch-up gaps form), then materialize: the
    tables within LAZY_TABLE_TOL, the losses within 2e-4."""
    dev = torch.device("cuda")
    on_card = [to_device((b, make_grad_index(b)), dev) for b in batches]
    runs = {}
    for lazy in (False, True):
        model = make_training_model(0.0)
        opt = FusedEmbeddingAdamW(1e-3, weight_decay=1e-5, lazy=lazy)
        state = opt.init(model)
        step = make_sparse_train_step(model, loss_fn, opt, state)
        losses = [step(on_card[i % 2], seed=200 + i).item() for i in range(6)]
        opt.materialize(model, state)
        runs[lazy] = (model.item_embedding.detach(), losses)
    (eager, eager_losses), (lazy, lazy_losses) = runs[False], runs[True]
    torch.testing.assert_close(lazy, eager, **LAZY_TABLE_TOL)
    np.testing.assert_allclose(lazy_losses, eager_losses, rtol=2e-4)
    return {"table_diff_max": (lazy - eager).abs().max().item(),
            "loss_rel_diff_max": float(np.max(np.abs(np.subtract(lazy_losses, eager_losses))
                                              / np.abs(eager_losses)))}


# ---------------------------------------------------------------------------
# Phase 8, chained: Trainer(chain=CHAIN) and graph replays against eager steps
# ---------------------------------------------------------------------------


def chained_corpus() -> tuple[SessionDataset, list, list]:
    """CHAIN_SESSIONS seeded sessions (make_dataset's mix), one shuffled
    epoch of its batches of 512, and the validation batches: the first CHAIN
    of the smallest node bucket (one chained evaluation) and one of the
    largest (a single eval step)."""
    t0 = time.perf_counter()
    dataset = make_dataset(np.random.default_rng(3), CHAIN_SESSIONS)
    epoch = list(iterate_batches(dataset, TRAIN_BATCH, shuffle=True, seed=0))
    counts = {n: sum(b.nodes_per_session == n for b in epoch) for n in BUCKETS}
    if counts[8] < CHAIN + SUBCHAIN or not all(counts.values()):
        raise AssertionError(f"the chained corpus's buckets {counts} hold no full group and sub-chain")
    val = [b for b in epoch if b.nodes_per_session == 8][:CHAIN] + [b for b in epoch if b.nodes_per_session == 56][:1]
    log(f"[phase 8] chained corpus: {CHAIN_SESSIONS} sessions, {len(epoch)} batches of {TRAIN_BATCH} "
        f"({counts}) assembled in {time.perf_counter() - t0:.1f} s")
    return dataset, epoch, val


def batch_engines() -> dict:
    """Phase 10: one shuffled epoch of the chained corpus's sessions in
    batches of 512, assembled on the host by the C++ engine (the default,
    built with g++ when phase 8 first asked for batches) and by the numpy
    engine, in turns (native, numpy, numpy, native); ms per batch of each.
    The two epochs are equal but for the negatives, which the C++ engine
    draws from its own stream and which exclude every item of their
    session."""
    dataset = make_dataset(np.random.default_rng(3), CHAIN_SESSIONS)
    runs: dict[str, list] = {"native": [], "numpy": []}
    epochs = {}
    for engine in ("native", "numpy", "numpy", "native"):
        t0 = time.perf_counter()
        epochs[engine] = list(iterate_batches(dataset, TRAIN_BATCH, shuffle=True, seed=0, engine=engine))
        runs[engine].append(1e3 * (time.perf_counter() - t0) / len(epochs[engine]))
    a, b = epochs["native"], epochs["numpy"]
    if len(a) != len(b):
        raise AssertionError(f"batch engines: {len(a)} native against {len(b)} numpy batches")
    order = np.random.default_rng(0).permutation(len(dataset))  # iterate_batches' shuffle at seed 0
    by_bucket = {n: [] for n in BUCKETS}
    for i in order:
        by_bucket[pick_bucket(int(dataset.unique_counts[i]), BUCKETS)].append(int(i))
    chunks = [by_bucket[n][lo:lo + TRAIN_BATCH] for n in BUCKETS for lo in range(0, len(by_bucket[n]), TRAIN_BATCH)]
    for k, (x, y) in enumerate(zip(a, b)):
        for f in ("node_ids", "node_mask", "adj", "num_nodes", "targets", "sample_mask"):
            if not torch.equal(getattr(x, f), getattr(y, f)):
                raise AssertionError(f"batch engines: batch {k} field {f} differs between the engines")
        for slot in range(int(x.sample_mask.sum())):
            items = set(dataset.session_items(chunks[k][slot]).tolist())
            if items & set(x.negatives[slot].tolist()):
                raise AssertionError(f"batch engines: batch {k} slot {slot} draws a negative from its session")
    return {"sessions": len(dataset), "batches": len(a),
            "native_ms_per_batch": runs["native"], "numpy_ms_per_batch": runs["numpy"],
            "speedup": statistics.median(runs["numpy"]) / statistics.median(runs["native"])}


def _state_tensors(model, state: dict) -> list:
    """Everything a sparse step writes: parameters and buffers, the table's
    moments and last_step, the other parameters' AdamW state."""
    rest = [t for s in state["rest"].state.values() for t in s.values()]
    table_state = [state[k] for k in ("emb_mu", "emb_nu", "last_step") if k in state]
    return [*model.state_dict().values(), *table_state, *rest]


def _graph_stats(cache) -> dict:
    return {"graphs": len(cache.graphs), "capture_s": cache.capture_seconds, "pool_bytes": cache.pool_bytes}


def chained_trainer(workdir: Path, chain: int, batches, val: list, transfer_workers: int = 1) -> Trainer:
    """Phases 8 and 11's Trainer: lazy, dropout 0.1, seed 7, 2 epochs of
    `batches(epoch)` with an evaluation of `val` after each."""
    return Trainer(make_training_model(DROPOUT), batches, lambda: iter(val),
                   optimizer=FusedEmbeddingAdamW(1e-3, weight_decay=1e-5, lazy=True),
                   output_dir=workdir, max_epochs=2, checkpoint_every=2, loss_fn=create_loss_function("dual"),
                   seed=7, sparse_embedding_grads=True, chain=chain, transfer_workers=transfer_workers)


def train_chained_full_width(epoch: list, val: list, workdir: Path) -> tuple[dict, tuple]:
    """The chained path: Trainer.train() with chain=CHAIN against the
    unchained Trainer.train() of the same seed (2 epochs of `epoch`, an
    evaluation of `val` after each): the same losses and metrics, the same
    table, moments, last_step, other parameters' state and BatchNorm
    buffers, bit for bit. The chained run is counted: per step 2 attention
    forward, 2 backward, 1 gather, 1 touched update; per evaluated batch 2
    forward and 1 scoring launch; per evaluation 1 materialize. Returns the
    result and the chained run's history and state (phase 11 compares the
    pipelined run with them)."""
    def trainer(out: str, chain: int) -> Trainer:
        return chained_trainer(workdir / out, chain, lambda e: iter(epoch), val)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = trainer("unchained", 1)
    want = plain.train()
    plain_s = time.perf_counter() - t0
    reset_launch_counts()
    t0 = time.perf_counter()
    chained = trainer("chained", CHAIN)
    got = chained.train()
    chained_s = time.perf_counter() - t0
    n_steps, n_evals = 2 * len(epoch), 2
    launches = expect_launches(
        "chained Trainer.train()", session_attention=2 * (n_steps + n_evals * len(val)),
        session_attention_backward=2 * n_steps, score_chunkmax=n_evals * len(val),
        lazy_gather_catch_up=n_steps, lazy_touched_update=n_steps, lazy_materialize=n_evals,
        node_dropout=4 * n_steps)
    if got != want:
        raise AssertionError(f"chained train() differs from the unchained one: {got} vs {want}")
    pairs = list(zip(_state_tensors(chained.model, chained.opt_state), _state_tensors(plain.model, plain.opt_state)))
    if len(pairs) < 10 or not all(_same_bits(a, b) for a, b in pairs):
        raise AssertionError("chained train() left a different state than the unchained one")
    # Per epoch: the full group of the smallest bucket and its SUBCHAIN rest;
    # per evaluation the full group of `val`.
    if chained.chained_dispatches != 2 * 2 or chained.chained_eval_dispatches != n_evals:
        raise AssertionError(f"chained dispatches {chained.chained_dispatches} (train), "
                             f"{chained.chained_eval_dispatches} (eval)")
    return {
        "chain": CHAIN, "steps": n_steps, "evaluations": n_evals, "launches": launches,
        "train_loss": got["train_loss"], "val_metrics": got["val_metrics"],
        "chained_dispatches": chained.chained_dispatches,
        "chained_eval_dispatches": chained.chained_eval_dispatches,
        "state_tensors_equal": len(pairs),
        "train_wall_s_unchained": plain_s, "train_wall_s_chained": chained_s,
        "train_graphs": _graph_stats(chained._chained_step.graphs),
        "eval_graphs": _graph_stats(chained._chained_eval.graphs),
    }, (got, chained.chained_dispatches, _state_tensors(chained.model, chained.opt_state))


def graph_steps_against_eager(batches: list, lazy: bool, groups: list) -> dict:
    """Full width, dropout 0.1: the same steps eagerly (one at a time) and
    through the chained step's graphs, from two copies of one seeded state,
    `groups` giving the chain lengths in turn (a length that repeats is a pure
    replay): losses and the whole state equal bit for bit. The chained run's
    launch counts are returned."""
    dev = torch.device("cuda")
    loss_fn = create_loss_function("dual")
    runs = []
    for chained in (False, True):
        model = make_training_model(DROPOUT)
        opt = FusedEmbeddingAdamW(1e-3, weight_decay=1e-5, lazy=lazy)
        state = opt.init(model)
        single = make_sparse_train_step(model, loss_fn, opt, state)
        step = make_chained_sparse_train_step(model, loss_fn, opt, state)
        torch.cuda.synchronize()
        reset_launch_counts()
        losses, i = [], 0
        for n in groups:
            group = [batches[(i + j) % len(batches)] for j in range(n)]
            gidxs = [make_grad_index(b) for b in group]
            seeds = [500 + i + j for j in range(n)]
            if chained:
                stacked = to_device((stack_batches(group), stack_grad_indices(gidxs)), dev)
                losses.append(step(*stacked, next_steps_block(model, opt, state, seeds, dev)))
            else:
                losses += [single(to_device((b, g), dev), s).reshape(1) for b, g, s in zip(group, gidxs, seeds)]
            i += n
        torch.cuda.synchronize()
        runs.append((torch.cat(losses), _state_tensors(model, state), launch_counts()))
        del model, opt, state, single, step
    (want, want_state, want_launches), (got, got_state, got_launches) = runs
    if not torch.equal(got, want) or not all(_same_bits(a, b) for a, b in zip(got_state, want_state)):
        raise AssertionError(f"graph replays differ from eager steps (lazy={lazy}, groups {groups})")
    if got_launches != want_launches:
        raise AssertionError(f"graph replays counted {got_launches}, eager steps {want_launches}")
    torch.cuda.empty_cache()
    return {"lazy": lazy, "groups": groups, "steps": sum(groups), "losses": got.tolist(),
            "state_tensors_equal": len(got_state), "launches": got_launches}


# ---------------------------------------------------------------------------
# Phase 11: the host pipeline (pooled assembly, side-stream prefetch), the benches
# ---------------------------------------------------------------------------


def pipelined_against_inline(dataset: SessionDataset, val: list, inline: tuple, workdir: Path) -> dict:
    """Phase 8's chained Trainer.train() once more from a new Trainer (a cold
    graph cache: the captures happen while the prefetch thread transfers),
    the epoch now assembled by iterate_batches on 3 threads from the dataset
    phase 8's batches came from and transferred on 3 threads: history and
    the whole state equal phase 8's inline run (its list of batches, one
    transfer thread) bit for bit."""
    want, want_dispatches, want_state = inline
    t0 = time.perf_counter()
    piped = chained_trainer(workdir, CHAIN, lambda e: iterate_batches(
        dataset, TRAIN_BATCH, shuffle=True, seed=0, workers=3), val, transfer_workers=3)
    got = piped.train()
    seconds = time.perf_counter() - t0
    if got != want:
        raise AssertionError(f"pipelined train() differs: {got} vs {want}")
    pairs = list(zip(_state_tensors(piped.model, piped.opt_state), want_state))
    if len(pairs) < 10 or not all(_same_bits(a, b) for a, b in pairs):
        raise AssertionError("pipelined train() left a different state than the inline one")
    if piped.chained_dispatches != want_dispatches:
        raise AssertionError(f"chained dispatches {piped.chained_dispatches} against {want_dispatches}")
    return {"chain": CHAIN, "workers": 3, "transfer_workers": 3, "train_loss": got["train_loss"],
            "state_tensors_equal": len(pairs), "chained_dispatches": piped.chained_dispatches,
            "train_wall_s_pipelined": seconds, "train_graphs": _graph_stats(piped._chained_step.graphs)}


def bench_runs() -> tuple[list, dict]:
    """gat_recommendation_torch.bench.main_e2e, lazy, on BENCH_SESSIONS
    sessions over the full catalog, for each of BENCH_RUNS, each with one
    traced epoch (the device's idle share) and the touched-row statistics.
    The first run is the counted path: per step 2 attention forward and 2
    backward, 1 gather, 1 touched update, 4 node dropout launches."""
    results, launches = [], None
    for chain, workers, transfer_workers in BENCH_RUNS:
        reset_launch_counts()
        result = bench.main_e2e(BENCH_SESSIONS, workers, BENCH_EPOCHS, chain, lazy=True,
                                transfer_workers=transfer_workers, profile=True)
        detail = result["_detail"]
        steps = detail["steps_per_epoch"] * (2 * BENCH_EPOCHS + 4)  # warm-up, short, long, traced
        if launches is None:
            launches = expect_launches(
                f"bench chain {chain}", session_attention=2 * steps, session_attention_backward=2 * steps,
                lazy_gather_catch_up=steps, lazy_touched_update=steps, node_dropout=4 * steps)
        if not (np.isfinite(result["value"]) and result["value"] > 0 and detail["steps_per_epoch"] > 0):
            raise AssertionError(f"bench chain {chain}: {result}")
        results.append(result)
        torch.cuda.empty_cache()
    return results, launches


def serving_latency(workdir: Path) -> tuple[dict, dict]:
    """gat_recommendation_torch.serving.latency_bench on phase 4's checkpoint
    and graph (full width): 200 requests of 2 .. 11 items at k = 10, after
    the Recommender's warm-up of one request per bucket. Counted: 2
    attention forward and 1 scoring launch a request, none of them through
    the batch kernels."""
    reset_launch_counts()
    results = latency_bench.run(workdir / "ckpt", workdir / "graph_edges.csv", device="cuda")
    exact = results["exact"]
    n = exact["n"] + len(BUCKETS)
    launches = launch_counts()
    want = {**dict.fromkeys(launches, 0), "session_attention": 2 * n, "score_chunkmax": n}
    if launches != want:
        raise AssertionError(f"latency bench launch counts {launches}, want {want}")
    if exact["n"] != 200 or not 0 < exact["p50"] <= exact["p95"] <= exact["p99"] < float("inf"):
        raise AssertionError(f"latency bench percentiles {exact}")
    return results, launches


# ---------------------------------------------------------------------------
# Phase 9, chained: wall time per step at chain 1 and chain TIMED_CHAIN
# ---------------------------------------------------------------------------

HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                     "cudaMemcpyAsync", "cudaMemsetAsync", "cudaGraphLaunch")


def group_profile(run, steps: int, wall_ms: float) -> dict:
    """A torch.profiler trace of one call of `run` (`steps` steps): the
    card's busy ms per step, its idle share against `wall_ms` (per step,
    unprofiled), its operations per step, and the host's launch calls
    (kernel launches, copies, sets, graph launches of the CUDA runtime and
    driver) per step."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = device_rows(prof)
    busy = sum(e.self_device_time_total for e in rows) / 1e3 / steps
    calls = {e.key: e.count for e in prof.key_averages() if e.key in HOST_LAUNCH_CALLS}
    return {
        "device_busy_ms_per_step": busy if rows else "not measured",
        "device_idle_share": 1.0 - busy / wall_ms if rows else "not measured",
        "device_ops_per_step": sum(e.count for e in rows) / steps,
        "host_launch_calls_per_step": sum(calls.values()) / steps if calls else "not measured",
        "host_launch_calls": calls,
    }


def chain_timing(epoch: list) -> dict:
    """Lazy steps at full width, B = 512, N = 56, dropout 0.1, float32
    moments, over TIMED_CHAIN batches of the N = 56 bucket (the corpus's,
    cycled), batches and indexes already on the card: chain 1 (the unchained
    step) and one chained group (one graph of a step, replayed per slot). Per
    step: wall ms (host clock, each group synchronised at its end, median of
    3 groups after the first), device ms (CUDA events around a group), and a
    profile of one group; for the chain the graphs, capture seconds and pool
    bytes."""
    dev = torch.device("cuda")
    loss_fn = create_loss_function("dual")
    n56 = [b for b in epoch if b.nodes_per_session == 56]
    batches = [n56[i % len(n56)] for i in range(TIMED_CHAIN)]
    gidxs = [make_grad_index(b) for b in batches]
    singles = [to_device((b, g), dev) for b, g in zip(batches, gidxs)]
    stacked = to_device((stack_batches(batches), stack_grad_indices(gidxs)), dev)
    model = make_training_model(DROPOUT)
    opt = FusedEmbeddingAdamW(1e-3, weight_decay=1e-5, lazy=True)
    state = opt.init(model)
    single = make_sparse_train_step(model, loss_fn, opt, state)
    chained = make_chained_sparse_train_step(model, loss_fn, opt, state)
    seeds = list(range(TIMED_CHAIN))
    runs = {
        "chain_1": lambda: [single(x, s) for x, s in zip(singles, seeds)],
        f"chain_{TIMED_CHAIN}": lambda: chained(*stacked, next_steps_block(model, opt, state, seeds, dev)),
    }
    out = {"shape": f"B={TRAIN_BATCH} N=56 U={stacked[1].uid.shape[1]} lazy f32 dropout={DROPOUT}"}
    for label, run in runs.items():
        run()  # the graph's capture happens here
        torch.cuda.synchronize()
        walls, device = [], []
        for _ in range(3):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            run()
            end.record()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3 / TIMED_CHAIN)
            device.append(start.elapsed_time(end) / TIMED_CHAIN)
        wall = statistics.median(walls)
        out[label] = {"wall_ms_per_step": wall, "wall_ms_per_step_runs": walls,
                      "device_elapsed_ms_per_step": statistics.median(device),
                      **group_profile(run, TIMED_CHAIN, wall)}
    out[f"chain_{TIMED_CHAIN}"].update(_graph_stats(chained.graphs))
    return out


# ---------------------------------------------------------------------------
# Phase 9: where a train step's time goes
# ---------------------------------------------------------------------------


def profile_training(model, loss_fn, optimizer, opt_state, by_bucket: dict, epoch: list) -> dict:
    """Sparse train steps at B=512, N=56, batches already on the card: the
    wall time per step (unprofiled, one synchronise at the end), and from a
    torch.profiler trace of the same steps the card's busy time and its
    kernels by device time. Idle share = 1 - busy / wall. Beside it the dense
    step's and the N=8 step's wall, and a warm Trainer epoch over `epoch`
    (host batches: index, pinning and copies included)."""
    dev = torch.device("cuda")
    sparse = make_sparse_train_step(model, loss_fn, optimizer, opt_state)
    dense = make_train_step(model, loss_fn, optimizer, opt_state)
    on_card = {n: to_device((by_bucket[n][0], make_grad_index(by_bucket[n][0])), dev) for n in (8, 56)}

    walls = {
        "sparse_step_wall_ms_n56": wall_ms(lambda: sparse(on_card[56], seed=1)),
        "sparse_step_wall_ms_n8": wall_ms(lambda: sparse(on_card[8], seed=1)),
        "dense_step_wall_ms_n56": wall_ms(lambda: dense(on_card[56][0], seed=1)),
    }
    warm = Trainer(model, lambda e: iter(epoch), lambda: iter(()), optimizer=optimizer,
                   loss_fn=loss_fn, sparse_embedding_grads=True)
    warm.init_state(reset_parameters=False, opt_state=opt_state)
    walls["trainer_epoch_wall_ms_per_step"] = wall_ms(warm.train_epoch, n=2) / len(epoch)
    busy = device_profile(lambda i: sparse(on_card[56], seed=i), walls["sparse_step_wall_ms_n56"])
    gen = torch.Generator(device="cuda").manual_seed(2)
    return {
        **walls,
        "attention_at_batch_adjacency": [attention_at_adjacency(on_card[n][0], gen) for n in (56, 8)],
        "sessions_per_s_n56": TRAIN_BATCH / walls["sparse_step_wall_ms_n56"] * 1e3,
        **{f"{k}_sparse_step": v for k, v in busy.items()},
    }


def wall_ms(fn, n: int = 5) -> float:
    """Host-clock ms per call of fn over n calls after one, synchronised at the end."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def device_profile(fn, wall: float, steps: int = 5) -> dict:
    """A torch.profiler trace of `steps` calls fn(i): the card's busy ms and
    its ops per call, the idle share against `wall` (ms per call, measured
    unprofiled), and the kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            fn(i)
        torch.cuda.synchronize()
    rows = device_rows(prof)
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3 / steps
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:12]
    return {
        "device_busy_ms_per": busy_ms if rows else "not measured",
        "device_idle_share": 1.0 - busy_ms / wall if rows else "not measured",
        "device_ops_per": sum(e.count for e in rows) / steps,
        "top_device_ms_per": {e.key[:80]: e.self_device_time_total / 1e3 / steps for e in top},
    }


def profile_lazy(loss_fn, by_bucket: dict) -> dict:
    """Lazy sparse steps at B=512, N=56 beside the eager ones above (same
    batch, dropout 0.1), from a lazy state twelve steps in, whose rows lag a
    few steps; then the same steps with every row at least 1,000 steps behind
    (the count moved on: every catch-up runs all 64 terms), and one
    materialize of the whole table from there (CUDA events)."""
    dev = torch.device("cuda")
    model = make_training_model(DROPOUT)
    opt = FusedEmbeddingAdamW(1e-3, weight_decay=1e-5, lazy=True)
    state = opt.init(model)
    step = make_sparse_train_step(model, loss_fn, opt, state)
    batches = [to_device((b, make_grad_index(b)), dev) for b in [by_bucket[n][0] for n in BUCKETS] * 3]
    for i, batch in enumerate(batches):
        step(batch, seed=300 + i)
    n56 = batches[BUCKETS.index(56)]
    out = {}
    for label in ("recent", "behind_1000"):
        if label == "behind_1000":
            state["count"] += 1000
        wall = wall_ms(lambda: step(n56, seed=1))
        out[f"lazy_step_wall_ms_n56_{label}"] = wall
        busy = device_profile(lambda i: step(n56, seed=i), wall)
        out.update({f"{k}_lazy_step_{label}": v for k, v in busy.items()})
    # One materialize of the whole table, every row 1,000 or more steps behind,
    # timed with CUDA events: the profiler's trace of this single call showed
    # no device time.
    state["count"] += 1000
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    opt.materialize(model, state)
    end.record()
    torch.cuda.synchronize()
    out["materialize_ms_behind_1000"] = start.elapsed_time(end)
    return out


# ---------------------------------------------------------------------------
# Phase 12: the rest of the model zoo at full width
# ---------------------------------------------------------------------------

# (label, registry name, config fields, node-dropout and attention-forward
# launches per train step with dropout). Node dropout: GAT 3 attention + 2
# node dropouts, GraphSAGE 3 node dropouts, the standard Graph Transformer 3
# layers x (node + 2 FFN); forward and backward each.
ZOO = (
    ("gat", "gat", {}, 10, 0),
    ("graphsage_mean", "graphsage", {"aggregator": "mean"}, 6, 0),
    ("graphsage_max", "graphsage", {"aggregator": "max"}, 6, 0),
    ("graphsage_lstm", "graphsage", {"aggregator": "lstm"}, 6, 0),
    ("graph_transformer", "graph_transformer", {}, 18, 3),
)
# The LSTM aggregator trains on node buckets up to this size: autograd keeps
# its gates and states for each of the N source slots of 3 layers, about
# 0.3 GB a slot at B = 512, N = 56 (some 50 GB a step), and each slot is a
# [B*N, 256] x [256, 1024] product.
ZOO_LSTM_MAX_NODES = 32
ZOO_CHAIN = 4
ZOO_HEADS = 4  # the standard Graph Transformer: 4 heads of 64
BENCH_GRAPH_SESSIONS = 120_436  # the bench's default corpus, whose graph the PE is computed on
# Node dropout on each zoo path beside phase 7's [512, 56, 256], which every
# model runs: GAT's attention weights [B, heads, N, N], the LSTM's largest
# trained bucket, the standard Graph Transformer's FFN hidden [B, N, 4 * 256].
ZOO_DROPOUT_SHAPES = {
    "gat": (TRAIN_BATCH, 4, 56, 56),
    "graphsage_lstm": (TRAIN_BATCH, ZOO_LSTM_MAX_NODES, DIM),
    "graph_transformer": (TRAIN_BATCH, 56, 4 * DIM),
}
# The smoke entry's shapes (smoke_test_all_models: 8 sessions of the 8-node
# bucket, widths 32, 500 items): attention of the standard Graph Transformer
# (4 heads of 8) and the optimized one (2 of 16); node dropout on nodes, on
# GAT's attention weights and on the FFN hidden; the dense AdamW's table.
SMOKE_BATCH, SMOKE_NODES, SMOKE_DIM = 8, 8, 32
SMOKE_HEADS = (4, 2)
SMOKE_DROPOUT_SHAPES = ((8, 8, 4 * SMOKE_DIM), (8, 8, SMOKE_DIM), (8, 4, 8, 8))
SMOKE_ROWS = padded_rows(smoke_test_all_models.NUM_ITEMS)


def with_shapes(row: dict, *others: dict) -> dict:
    """`row` (a kernel's check at a path's main shape) with the shapes of
    every check of that kernel on the path, their errors and ms, and for the
    attention forward the kernel each shape took."""
    return {**row, "shapes_checked": [{k: r[k] for k in ("shape", "kernel", "max_abs_err", "ms") if k in r}
                                      for r in (row, *others)]}


def seeded_weights_on_card_and_cpu(workdir: Path) -> dict:
    """Every model of the registry at full width (NUM_ITEMS, each factory's
    defaults; the optimized Graph Transformer is the main path's model at
    256/256), drawn from seed 0 of a CPU generator with no device (which
    must be the card) and with device="cpu": the states EQUAL bit for bit,
    each build's seconds (the draw is on the host: a 466,944 x 256 table is
    119.5 M uniform numbers); then Trainer(seed=7).init_state() over the
    main path's model on both, the states EQUAL again, and its seconds."""

    def timed(make):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        made = make()
        torch.cuda.synchronize()
        return made, time.perf_counter() - t0

    def equal_states(card, cpu, what: str) -> int:
        got, want = card.state_dict(), cpu.state_dict()
        differ = [k for k in want if k not in got or not torch.equal(got[k].cpu(), want[k])]
        if list(got) != list(want) or differ:
            raise AssertionError(f"{what}: the card's seeded state differs from the CPU's at {differ or list(got)}")
        return len(want)

    out = {"host_threads": torch.get_num_threads(), "host_cpus": os.cpu_count(), "models": {}}
    for name in MODEL_NAMES:
        made = {"cuda": timed(lambda: create_model(name, NUM_ITEMS, generator=torch.Generator().manual_seed(0))),
                "cpu": timed(lambda: create_model(name, NUM_ITEMS, device="cpu",
                                                  generator=torch.Generator().manual_seed(0)))}
        if made["cuda"][0].item_embedding.device.type != "cuda":
            raise AssertionError("create_model without a device must allocate on the card")
        out["models"][name] = {"state_tensors_equal": equal_states(made["cuda"][0], made["cpu"][0], name),
                               "card_s": made["cuda"][1], "cpu_s": made["cpu"][1]}
        if name != "graph_transformer_optimized":
            del made
            continue
        for device, (model, _) in made.items():
            trainer = Trainer(model, lambda e: iter(()), lambda: iter(()), output_dir=workdir / device, seed=7,
                              device=device)
            out[f"trainer_init_state_{device}_s"] = timed(trainer.init_state)[1]
        out["trainer_state_tensors_equal"] = equal_states(made["cuda"][0], made["cpu"][0], "Trainer.init_state")
        del made, model, trainer
    torch.cuda.empty_cache()
    return out


def train_zoo_model(label: str, name: str, fields: dict, node_dropouts: int, attention: int,
                    by_bucket: dict, epoch: list, workdir: Path) -> dict:
    """One model of ZOO at full width: Trainer.train() with the lazy optimizer,
    2 epochs of phase 8's batches (the LSTM's up to ZOO_LSTM_MAX_NODES) with
    dropout 0.1 and an evaluation of one N = 56 batch after each, counted
    (per step 1 gather, 1 touched update, `node_dropouts` node-dropout and
    `attention` attention launches forward and backward; per evaluation 1
    materialize, 1 scoring launch and `attention` forwards); then 4 lazy
    steps on one repeated batch from outside the epoch (the loss must fall); the ms of a lazy step
    at the largest bucket it trains on, from a torch.profiler trace, with the
    peak device memory; two lazy steps with dropout 0 against a CPU copy
    (zoo_against_cpu_copy)."""
    loss_fn = create_loss_function("dual")
    max_nodes = ZOO_LSTM_MAX_NODES if fields.get("aggregator") == "lstm" else max(BUCKETS)
    batches = [b for b in epoch if b.nodes_per_session <= max_nodes]
    make = lambda dropout, device=None: make_seeded_model(name, fields, dropout, device)  # noqa: E731
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    trainer = Trainer(make(DROPOUT), lambda e: iter(batches), lambda: iter([by_bucket[56][0]]),
                      optimizer=FusedEmbeddingAdamW(1e-3, weight_decay=1e-5, lazy=True),
                      output_dir=workdir / label, max_epochs=2, checkpoint_every=2, loss_fn=loss_fn, seed=7,
                      sparse_embedding_grads=True)
    history = trainer.train()
    train_s = time.perf_counter() - t0
    n_steps, n_evals = 2 * len(batches), 2
    launches = expect_launches(
        f"{label} lazy Trainer.train()", session_attention=attention * (n_steps + n_evals),
        session_attention_backward=attention * n_steps, score_chunkmax=n_evals,
        lazy_gather_catch_up=n_steps, lazy_touched_update=n_steps, lazy_materialize=n_evals,
        node_dropout=node_dropouts * n_steps)
    if not all(np.isfinite(history["train_loss"])) or len(history["val_metrics"]) != n_evals:
        raise AssertionError(f"{label} train(): {history}")

    model, opt, state = trainer.model, trainer.optimizer, trainer.opt_state
    step = make_sparse_train_step(model, loss_fn, opt, state)
    dev = torch.device("cuda")
    fresh = next(b for b in by_bucket[8] if all(b is not e for e in epoch))  # a batch it has not memorized
    repeated = to_device((fresh, make_grad_index(fresh)), dev)
    losses = [step(repeated, seed=100 + i).item() for i in range(4)]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: repeated-batch losses must be finite and fall: {losses}")

    timed = to_device((by_bucket[max_nodes][0], make_grad_index(by_bucket[max_nodes][0])), dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wall = wall_ms(lambda: step(timed, seed=1), n=3)
    busy = device_profile(lambda i: step(timed, seed=i), wall, steps=3)
    peak = torch.cuda.max_memory_allocated()
    del trainer, model, opt, state, step, repeated, timed
    torch.cuda.empty_cache()
    return {
        "model": label, "steps": n_steps, "evaluations": n_evals, "launches": launches,
        "train_loss": history["train_loss"], "val_metrics": history["val_metrics"], "train_wall_s": train_s,
        "repeated_batch_losses": losses,
        "lazy_step": {"N": max_nodes, "wall_ms": wall, "peak_memory_bytes": peak,
                      **{f"{k}_step": v for k, v in busy.items()}},
        "cpu_copy": zoo_against_cpu_copy([by_bucket[8][0], by_bucket[16][0]], loss_fn, make,
                                         max_aggregator=fields.get("aggregator") == "max"),
    }


def zoo_chained_against_unchained(name: str, fields: dict, chain_epoch: list, workdir: Path) -> dict:
    """Trainer.train() at chain ZOO_CHAIN against the unchained run of the
    same seed: lazy, dropout 0.1, one epoch of five N = 8 batches of the
    chained corpus (a full group and a single step) and one N = 56 batch, an
    evaluation of four N = 8 batches (one chained evaluation): history and
    the whole state equal bit for bit, a chained dispatch of each kind."""
    n8 = [b for b in chain_epoch if b.nodes_per_session == 8]
    batches = n8[:5] + [b for b in chain_epoch if b.nodes_per_session == 56][:1]
    runs = []
    for chain in (1, ZOO_CHAIN):
        trainer = Trainer(make_seeded_model(name, fields, DROPOUT), lambda e: iter(batches), lambda: iter(n8[:4]),
                          optimizer=FusedEmbeddingAdamW(1e-3, weight_decay=1e-5, lazy=True),
                          output_dir=workdir / f"{name}_chain_{chain}", max_epochs=1,
                          loss_fn=create_loss_function("dual"), seed=7, sparse_embedding_grads=True, chain=chain)
        runs.append((trainer.train(), trainer))
    (want, plain), (got, chained) = runs
    if got != want:
        raise AssertionError(f"{name}: chained train() differs from the unchained one: {got} vs {want}")
    pairs = list(zip(_state_tensors(chained.model, chained.opt_state), _state_tensors(plain.model, plain.opt_state)))
    if len(pairs) < 10 or not all(_same_bits(a, b) for a, b in pairs):
        raise AssertionError(f"{name}: chained train() left a different state than the unchained one")
    if chained.chained_dispatches != 1 or chained.chained_eval_dispatches != 1:
        raise AssertionError(f"{name}: chained dispatches {chained.chained_dispatches}, "
                             f"{chained.chained_eval_dispatches}")
    out = {"model": name, "chain": ZOO_CHAIN, "steps": len(batches), "train_loss": got["train_loss"],
           "state_tensors_equal": len(pairs), "train_graphs": _graph_stats(chained._chained_step.graphs)}
    del runs, plain, chained
    torch.cuda.empty_cache()
    return out


def make_zoo_checkpoint(path: Path, name: str, fields: dict) -> None:
    """A full-width checkpoint of a model of the registry, seeded, its
    BatchNorm statistics and affine parameters perturbed (as make_checkpoint)."""
    gen = torch.Generator().manual_seed(0)
    model = create_model(name, NUM_ITEMS, generator=gen, device="cpu", **fields)
    with torch.no_grad():
        for bn in model.batch_norms:
            bn.mean.normal_(0.0, 0.3, generator=gen)
            bn.var.uniform_(0.5, 2.0, generator=gen)
            bn.scale.uniform_(0.5, 1.5, generator=gen)
            bn.bias.normal_(0.0, 0.2, generator=gen)
    checkpoint.save(path, model, epoch=0, best_val_metric=0.0)


def serve_zoo_model(name: str, fields: dict, workdir: Path) -> dict:
    """A full-width checkpoint behind the Recommender on the card, phase 4's
    12 requests (its graph and sessions from the same seed), each against a
    CPU copy (SERVE_TOL); counted: 1 scoring launch and nothing else a
    request (GAT and GraphSAGE have no attention kernel)."""
    rng = np.random.default_rng(0)
    make_edges(workdir / "graph_edges.csv", rng)
    sessions = make_sessions(rng)
    make_zoo_checkpoint(workdir / name, name, fields)
    rec = Recommender(workdir / name, workdir / "graph_edges.csv", device="cuda")
    cpu = Recommender(workdir / name, workdir / "graph_edges.csv", device="cpu", warmup=False, int8_scoring=False)
    requests = [validate_request(_Req(items, k), NUM_ITEMS) for items, k in sessions]
    torch.cuda.synchronize()
    reset_launch_counts()
    latencies, answers = [], []
    for v in requests:
        t0 = time.perf_counter()
        answers.append(rec.recommend(v))
        latencies.append((time.perf_counter() - t0) * 1e3)
    launches = launch_counts()
    want = {**dict.fromkeys(launches, 0), "score_chunkmax": len(requests)}
    if launches != want:
        raise AssertionError(f"{name} serving launch counts {launches}, want {want}")
    for v, answer in zip(requests, answers):
        agree(answer, cpu.recommend(v))
    del rec, cpu
    torch.cuda.empty_cache()
    return {"model": name, "requests": len(requests), "launches": launches,
            "ms_p50": statistics.median(latencies), "ms_max": max(latencies)}


def pe_on_the_bench_graph(workdir: Path) -> dict:
    """Laplacian PE (k = 16) of the bench's default corpus graph
    (BENCH_GRAPH_SESSIONS sessions, the port's build_co_event_graph) into a
    full-width optimized Graph Transformer on the card, its seconds; then the
    model's checkpoint behind the Recommender, one request against a CPU copy."""
    t0 = time.perf_counter()
    sid, ts, items = bench.corpus_columns(BENCH_GRAPH_SESSIONS, NUM_ITEMS)
    edges, _ = build_co_event_graph((sid, ts, items, "view"))
    graph_s = time.perf_counter() - t0
    model = make_training_model(DROPOUT)
    t0 = time.perf_counter()
    model.precompute_pe(edges["item_i"], edges["item_j"])
    torch.cuda.synchronize()
    pe_s = time.perf_counter() - t0
    pe = model.cached_pe
    rows = int(pe.any(dim=1).sum())
    if not (0 < rows < NUM_ITEMS) or bool(pe[NUM_ITEMS:].any()) or not bool(torch.isfinite(pe).all()):
        raise AssertionError(f"cached_pe: {rows} rows filled, phantom tail zero: {not bool(pe[NUM_ITEMS:].any())}")
    checkpoint.save(workdir / "pe_ckpt", model, epoch=0, best_val_metric=0.0)
    del model
    np.savez(workdir / "bench_edges.npz", item_i=edges["item_i"], item_j=edges["item_j"])
    rec = Recommender(workdir / "pe_ckpt", workdir / "bench_edges.npz", device="cuda", warmup=False)
    cpu = Recommender(workdir / "pe_ckpt", workdir / "bench_edges.npz", device="cpu", warmup=False,
                      int8_scoring=False)
    session = items[sid == 0]
    request = validate_request(_Req([int(i) for i in session], 10), NUM_ITEMS)
    agree(rec.recommend(request), cpu.recommend(request))
    del rec, cpu
    torch.cuda.empty_cache()
    return {"edges": len(edges["item_i"]), "graph_s": graph_s, "precompute_pe_s": pe_s, "rows_with_pe": rows,
            "request_items": len(set(session.tolist()))}


def start_smoke_child() -> subprocess.Popen:
    """``python3 -m gat_recommendation_torch.smoke_test_all_models`` in a child
    process on the card (its start-up takes half a minute, so it runs beside
    the checks that time nothing on the card)."""
    return subprocess.Popen([sys.executable, "-m", "gat_recommendation_torch.smoke_test_all_models"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=Path(__file__).resolve().parent)


def smoke_entry(child: subprocess.Popen) -> dict:
    """gat_recommendation_torch.smoke_test_all_models on the card: its main()
    in this process, counted (4 models x 8 dense steps: 1 dense AdamW each;
    node dropout and attention as each model's layers take them, the
    attention at B = 8 through the row kernel); and the child of
    start_smoke_child, which must exit 0 with four PASS rows."""
    torch.cuda.synchronize()
    reset_launch_counts()
    rc = smoke_test_all_models.main([])
    launches = launch_counts()
    steps = smoke_test_all_models.EPOCHS * 4
    # Per dense step with dropout: graphsage 6, gat 10, graph_transformer 18,
    # graph_transformer_optimized 4 node-dropout launches; attention forward
    # and backward 3 + 2 (the Graph Transformers' layers), every one of them
    # on the batches' packed adjacency.
    want = {**dict.fromkeys(launches, 0), "embedding_adamw": 4 * steps, "node_dropout": 38 * steps,
            **dict.fromkeys(("session_attention", "session_attention_backward", "session_attention_packed",
                             "session_attention_backward_packed"), 5 * steps)}
    if rc != 0 or launches != want:
        raise AssertionError(f"smoke_test_all_models.main: rc {rc}, launch counts {launches}, want {want}")
    stdout, stderr = child.communicate(timeout=600)
    rows = [line.split()[:2] for line in stdout.splitlines()[1:]]
    if child.returncode != 0 or [r[1] for r in rows] != ["PASS"] * 4:
        raise AssertionError(f"python3 -m gat_recommendation_torch.smoke_test_all_models: rc {child.returncode}"
                             f"\n{stdout}\n{stderr[-2000:]}")
    return {"rc": child.returncode, "table": stdout.splitlines(), "launches": launches}


# ---------------------------------------------------------------------------
# Phase 13: the Quickstart on the card
# ---------------------------------------------------------------------------

REPO = Path(__file__).resolve().parent
QUICKSTART_MODEL = "graph_transformer_optimized"  # train_baseline's default
# The JAX TPU run's validation recall@10 after epochs 1 and 2 with
# train_baseline's defaults on corpus v3 (docs/EXPERIMENTS.md:44-70): a quality
# reference, not a speed. The port's 2-epoch run must reach QUICKSTART_RECALL_FLOOR
# (the popularity baseline is 0.078).
TPU_HISTORY_RECALL_AT_10 = (0.2883, 0.3362)
QUICKSTART_RECALL_FLOOR = 0.25
GATE_METRIC_TOL = 1e-9  # the gate's metrics phase runs evaluate_local's code on the same batches
# Where phase 13 leaves (b)'s checkpoint_best (the defaults' run) for phase 17's export.
EXPORTED_CHECKPOINT = "eager_checkpoint_best"
EVAL_BATCH, PIPELINE_BATCH, PIPELINE_DIM = 256, 32, 64


def _bucket_index(ds: SessionDataset) -> np.ndarray:
    """Each session's node bucket, as an index into BUCKETS."""
    return np.minimum(np.searchsorted(BUCKETS, ds.unique_counts), len(BUCKETS) - 1)


def batches_per_epoch(ds: SessionDataset, batch_size: int) -> int:
    """How many batches iterate_batches makes of `ds`: each node bucket's
    sessions in batches of `batch_size`."""
    return int(sum(-(-int(n) // batch_size) for n in np.bincount(_bucket_index(ds))))


def buckets_filled(*datasets: SessionDataset) -> list[int]:
    """The node buckets that the datasets' sessions fill, the one with the
    most sessions first (every batch is padded to the batch size, so these
    are the N the path's kernels see)."""
    counts = sum(np.bincount(_bucket_index(ds), minlength=len(BUCKETS)) for ds in datasets)
    return [BUCKETS[i] for i in np.argsort(-counts, kind="stable") if counts[i]]


def quickstart_corpus(workdir: Path) -> dict:
    """Corpus v3 from MANIFEST.json through the port's pandas-free pipeline;
    the six text files must match their sha256; the npz (whose compressed
    bytes depend on the host's zlib) must hold the arrays of the CSV."""
    manifest = json.loads(regen_refscale.MANIFEST.read_text())
    log(f"[phase 13] numpy {np.__version__}: regenerating corpus v3 from {manifest['generator_params']}")
    seconds = regen_refscale.generate(manifest["generator_params"], workdir)
    bad = regen_refscale.check(manifest, workdir)
    text = [b for b in bad if not b[0].endswith(".npz")]
    if text:
        raise AssertionError(f"regenerated files differ from the manifest: {text}")
    processed = workdir / "processed"
    csv_cols = read_csv(processed / "graph_edges.csv", usecols=("item_i", "item_j", "count", "last_ts"))
    with np.load(processed / "graph_edges.npz") as z:
        if sorted(z.files) != sorted(csv_cols) or not all(np.array_equal(z[k], csv_cols[k]) for k in z.files):
            raise AssertionError("graph_edges.npz does not hold the arrays of graph_edges.csv")
    return {"stage_s": seconds, "numpy": np.__version__, "text_files_matched": 6,
            "npz_sha256": regen_refscale.sha256(processed / "graph_edges.npz"), "npz_matches_manifest": not bad,
            "edges": len(csv_cols["item_i"])}


def timed_on_card(fn, into: list):
    """fn, recording the wall seconds of each call, the card drained at both ends."""
    def run(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        into.append(time.perf_counter() - t0)
        return out
    return run


def train_cli(argv: list[str]) -> dict:
    """What train_baseline.main(argv) does, through its parse_args, build,
    initialize and run, in this process: the Trainer kept, its epochs and
    evaluations and the model's Laplacian PE timed."""
    kept: dict = {"epoch_s": [], "eval_s": [], "pe_s": []}
    t0 = time.perf_counter()
    args = train_baseline.parse_args(argv)
    model, trainer, edges = train_baseline.build(args)
    model.precompute_pe = timed_on_card(model.precompute_pe, kept["pe_s"])
    trainer.train_epoch = timed_on_card(trainer.train_epoch, kept["epoch_s"])
    trainer.evaluate = timed_on_card(trainer.evaluate, kept["eval_s"])
    train_baseline.initialize(args, model, trainer, edges)
    train_baseline.run(args, trainer)
    kept["wall_s"] = time.perf_counter() - t0
    kept["trainer"] = trainer
    return kept


def train_summary(kept: dict, train_sessions: int, out: Path) -> dict:
    trainer = kept["trainer"]
    history = json.loads((out / QUICKSTART_MODEL / "history.json").read_text())
    return {
        "steps": trainer.opt_state["count"],
        "chained_dispatches": trainer.chained_dispatches,
        "chained_eval_dispatches": trainer.chained_eval_dispatches,
        "epoch_s": kept["epoch_s"],
        "sessions_per_s": [train_sessions / s for s in kept["epoch_s"]],
        "eval_s": kept["eval_s"],
        "save_s": {f"{c['which']}@{c['epoch']}": c["seconds"] for c in trainer.checkpoint_log if c["op"] == "save"},
        "pe_s": kept["pe_s"],
        "wall_s": kept["wall_s"],
        "train_loss": history["train_loss"],
        "val_recall_at_10": [m["recall@10"] for m in history["val_metrics"]],
        "val_ndcg_at_10": [m["ndcg@10"] for m in history["val_metrics"]],
    }


def quickstart_training(processed: Path, workdir: Path, val_ds: SessionDataset) -> tuple[dict, dict]:
    """(b) train_baseline with the JAX script's defaults (eager sparse AdamW,
    batch 128, chain 32, 3 / 2 threads, dropout 0.1) for 2 epochs; (c) the
    main training path, --lazy-adamw --batch-size 512, 2 epochs, then
    --resume to 3. Launch counts per step and evaluation batch, the quality
    floor, the resume."""
    info = json.loads((processed / "split_info.json").read_text())
    data = ["--train-sessions", str(processed / "train.csv"), "--val-sessions", str(processed / "val.csv"),
            "--graph-edges", str(processed / "graph_edges.csv")]
    out = {}

    reset_launch_counts()
    kept = train_cli([*data, "--output-dir", str(workdir / "eager"), "--max-epochs", "2"])
    steps, evals = kept["trainer"].opt_state["count"], 2 * batches_per_epoch(val_ds, 128)
    launches = expect_counts("quickstart train_baseline (defaults)", session_attention=2 * steps + 2 * evals,
                             session_attention_backward=2 * steps, sparse_adamw=steps, node_dropout=4 * steps,
                             score_chunkmax=evals)
    eager = train_summary(kept, info["train_sessions"], workdir / "eager")
    del kept
    if eager["chained_dispatches"] < 1 or eager["chained_eval_dispatches"] < 1:
        raise AssertionError(f"the default run chained nothing: {eager}")
    best = max(eager["val_recall_at_10"])
    if best < QUICKSTART_RECALL_FLOOR:
        raise AssertionError(f"val recall@10 {eager['val_recall_at_10']}: best {best} < {QUICKSTART_RECALL_FLOOR}")
    out["train"] = {**eager, "launches": launches, "best_val_recall_at_10": best,
                    "tpu_history_val_recall_at_10": TPU_HISTORY_RECALL_AT_10}
    torch.cuda.empty_cache()

    lazy_flags = [*data, "--output-dir", str(workdir / "lazy"), "--lazy-adamw", "--batch-size", "512"]
    reset_launch_counts()
    kept = train_cli([*lazy_flags, "--max-epochs", "2"])
    steps, n_eval = kept["trainer"].opt_state["count"], 2
    evals = n_eval * batches_per_epoch(val_ds, 512)
    launches = expect_counts("quickstart train_baseline --lazy-adamw", session_attention=2 * steps + 2 * evals,
                             session_attention_backward=2 * steps, lazy_gather_catch_up=steps,
                             lazy_touched_update=steps, lazy_materialize=n_eval, node_dropout=4 * steps,
                             score_chunkmax=evals)
    lazy = train_summary(kept, info["train_sessions"], workdir / "lazy")
    del kept
    torch.cuda.empty_cache()
    kept = train_cli([*lazy_flags, "--max-epochs", "3", "--resume"])
    resumed = json.loads((workdir / "lazy" / QUICKSTART_MODEL / "history.json").read_text())
    if kept["trainer"].current_epoch != 2 or len(resumed["train_loss"]) != 3:
        raise AssertionError(f"the resumed run did not go on at epoch 3: {resumed}")
    if resumed["train_loss"][:2] != lazy["train_loss"] or \
            [m["recall@10"] for m in resumed["val_metrics"][:2]] != lazy["val_recall_at_10"]:
        raise AssertionError("the resumed history changed the first two epochs")
    out["lazy"] = {**lazy, "launches": launches, "resumed_train_loss": resumed["train_loss"],
                   "resumed_val_recall_at_10": [m["recall@10"] for m in resumed["val_metrics"]],
                   "resume_steps": kept["trainer"].opt_state["count"] - steps,
                   "restore_s": [c["seconds"] for c in kept["trainer"].checkpoint_log if c["op"] == "restore"]}
    del kept
    torch.cuda.empty_cache()
    return out, info


def quickstart_evaluation(processed: Path, workdir: Path) -> dict:
    """(d) evaluate_local on both output dirs against test.csv at batch 256,
    then the quality gate on the default run's checkpoint_best with the repo's
    thresholds: artifact and latency pass, its metrics equal evaluate_local's,
    its exit code 0 exactly when every phase passed. Counted."""
    data = ["--test-sessions", str(processed / "test.csv"), "--graph-edges", str(processed / "graph_edges.csv")]
    test_batches = batches_per_epoch(evaluate_local.load_test_split(*data[1::2]), EVAL_BATCH)
    out: dict = {"test_batches": test_batches}
    for label in ("eager", "lazy"):
        results_file = workdir / f"evaluation_{label}.json"
        reset_launch_counts()
        t0 = time.perf_counter()
        if evaluate_local.main([*data, "--outputs-dir", str(workdir / label), "--batch-size", str(EVAL_BATCH),
                                "--results-file", str(results_file)]) != 0:
            raise AssertionError(f"evaluate_local on {label} failed")
        seconds = time.perf_counter() - t0
        metrics = json.loads(results_file.read_text())[QUICKSTART_MODEL]
        if "error" in metrics:
            raise AssertionError(f"evaluate_local on {label}: {metrics['error']}")
        out[f"eval_{label}"] = {**metrics, "seconds": seconds, "launches": expect_counts(
            f"evaluate_local {label}", session_attention=2 * test_batches, score_chunkmax=test_batches)}

    gate_file = workdir / "quality_gate_results.json"
    reset_launch_counts()
    t0 = time.perf_counter()
    rc = model_quality_gate.main([*data, "--checkpoint", str(workdir / "eager" / QUICKSTART_MODEL / "checkpoint_best"),
                                  "--thresholds", str(REPO / "configs" / "quality_thresholds.yaml"),
                                  "--results-file", str(gate_file)])
    seconds = time.perf_counter() - t0
    gate = json.loads(gate_file.read_text())
    phases = gate["phases"]
    passed = {name: not (p.get("error") or p.get("failures")) for name, p in phases.items()}
    if not (passed.get("artifact") and passed.get("latency")):
        raise AssertionError(f"the gate's artifact or latency phase failed: {phases}")
    if (rc == 0) != all(passed.values()) or gate["pass"] != (rc == 0):
        raise AssertionError(f"the gate's exit code {rc} does not follow its phases {passed}")
    want = out["eval_eager"]
    for key in ("recall@10", "recall@20", "ndcg@10", "ndcg@20"):
        if abs(phases["metrics"][key] - want[key]) > GATE_METRIC_TOL:
            raise AssertionError(f"the gate's {key} {phases['metrics'][key]} differs from evaluate_local's {want[key]}")
    requests = len(BUCKETS) + 50  # the Recommender's warm-up, one a bucket, and --latency-requests
    out["gate"] = {"exit_code": rc, "passed": passed, "failures": phases["metrics"]["failures"],
                   "p50_ms": phases["latency"]["p50"], "p95_ms": phases["latency"]["p95"],
                   "p99_ms": phases["latency"]["p99"], "size_mb": phases["artifact"]["size_mb"], "seconds": seconds,
                   "launches": expect_counts("quality gate", session_attention=2 * (test_batches + requests),
                                             score_chunkmax=test_batches + requests)}
    return out


def quickstart_pipeline(processed: Path, workdir: Path) -> dict:
    """(e) run_full_pipeline with its defaults (100 sessions, 3 epochs, batch
    32) on the train split: exit 0, all four models passing, kernel 4 once a
    step; per step 2 + 3 attention launches (the two Graph Transformers) and
    4 + 18 + 10 + 6 node dropouts (forward and backward)."""
    subset = SessionDataset(run_full_pipeline.session_subset(str(processed / "train.csv"), 100),
                            load_edges(processed / "graph_edges.csv"))
    per_epoch = batches_per_epoch(subset, PIPELINE_BATCH)
    steps = 3 * per_epoch
    results_file = workdir / "pipeline_validation.json"
    reset_launch_counts()
    t0 = time.perf_counter()
    rc = run_full_pipeline.main(["--train-sessions", str(processed / "train.csv"),
                                 "--graph-edges", str(processed / "graph_edges.csv"),
                                 "--results-file", str(results_file)])
    seconds = time.perf_counter() - t0
    results = json.loads(results_file.read_text())
    if rc != 0 or not results["pass"] or not all(r["pass"] for r in results["models"].values()):
        raise AssertionError(f"run_full_pipeline failed (exit {rc}): {results}")
    launches = expect_counts("run_full_pipeline", embedding_adamw=4 * steps,
                             session_attention=5 * steps + 5 * per_epoch, session_attention_backward=5 * steps,
                             node_dropout=(4 + 18 + 10 + 6) * steps, score_chunkmax=4 * per_epoch)
    return {"num_items": subset.num_items, "buckets": buckets_filled(subset), "steps_per_model": steps,
            "seconds": seconds, "launches": launches, "models": results["models"]}


def grad_index_sizes(ds: SessionDataset, batch_size: int) -> list[tuple[int, int]]:
    """(U, unique rows) of the grad index of the batch of `batch_size` in
    `ds`'s epoch with the most unique rows, then of its first batch."""
    sizes = []
    for batch in iterate_batches(ds, batch_size):
        gidx = make_grad_index(batch)
        sizes.append((len(gidx.uid), int((gidx.uid != UID_SENTINEL).sum())))
    return [max(sizes, key=lambda size: size[1]), sizes[0]]


def quickstart_kernels(gen: torch.Generator, splits: dict[str, SessionDataset], pipeline: dict,
                       sass: dict) -> dict:
    """(f) each kernel of the Quickstart's paths against its plain version at
    that path's own shapes, timed with its bound as in phase 7: the
    attention and node dropout at every node bucket the path's sessions fill
    (corpus v3's sessions have at most 17 unique items), the main shape (the
    bucket with the most sessions) first; the row-sized AdamW kernels at the
    U and unique rows of two real training batches at the path's batch size
    (grad_index_sizes). `splits`: corpus v3's train, val and test splits;
    `pipeline`: the result of quickstart_pipeline; `sass`: lazy_series_sass
    of the built library."""
    trained = buckets_filled(splits["train"], splits["val"])  # the Trainer's steps and evaluations
    tested = buckets_filled(splits["test"])
    rows = {
        "train_attention": [check_attention_training(128, N, DROPOUT, gen, packed=True) for N in trained],
        "train_dropout": [check_node_dropout(gen, (128, N, DIM)) for N in trained],
        "train_sparse_adamw": [check_sparse_adamw(gen, torch.float32, False, U=U, n_unique=n)
                               for U, n in grad_index_sizes(splits["train"], 128)],
        "train_score": check_scoring(gen, 128),
        # --lazy-adamw --batch-size 512
        "lazy_attention": [check_attention_training(TRAIN_BATCH, N, DROPOUT, gen, packed=True) for N in trained],
        "lazy_dropout": [check_node_dropout(gen, (TRAIN_BATCH, N, DIM)) for N in trained],
        "lazy_adamw": [check_lazy_kernels(gen, torch.float32, False, sass, U=U, n_unique=n)
                       for U, n in grad_index_sizes(splits["train"], TRAIN_BATCH)],
        "lazy_score": check_scoring(gen, TRAIN_BATCH),
        "eval_attention": [check_attention(EVAL_BATCH, N, gen, packed=True) for N in tested],
        "eval_score": check_scoring(gen, EVAL_BATCH),
        # the gate's latency phase (the Recommender, bool adjacency): one request a
        # bucket to warm up, then 2-9 items a request
        "gate_attention": [check_attention(1, N, gen) for N in BUCKETS],
        "gate_score": check_scoring(gen, 1),
        "pipeline_attention": [check_attention_training(PIPELINE_BATCH, N, DROPOUT, gen, heads=h, dim=PIPELINE_DIM,
                                                        packed=True)
                               for h in (2, 4) for N in pipeline["buckets"]],
        # hidden states, the Graph Transformer's FFN, GAT's attention weights
        "pipeline_dropout": [check_node_dropout(gen, shape) for N in pipeline["buckets"] for shape in
                             ((PIPELINE_BATCH, N, PIPELINE_DIM), (PIPELINE_BATCH, N, 4 * PIPELINE_DIM),
                              (PIPELINE_BATCH, 4, N, N))],
        "pipeline_adamw": check_embedding_adamw(gen, torch.float32, False, rows=padded_rows(pipeline["num_items"]),
                                                dim=PIPELINE_DIM),
        "pipeline_score": check_scoring(gen, PIPELINE_BATCH, num_items=pipeline["num_items"], dim=PIPELINE_DIM),
    }
    torch.cuda.empty_cache()
    return rows


def quickstart(gen: torch.Generator, sass: dict, workdir: Path) -> dict:
    """Phase 13: (a) to (f), in `workdir` (corpus v3 stays in its data/
    for phase 15, (b)'s checkpoint_best in EXPORTED_CHECKPOINT for phase 17).
    `sass`: lazy_series_sass of the built library."""
    out: dict = {}
    t0 = time.perf_counter()
    out["corpus"] = quickstart_corpus(workdir / "data")
    log(f"[phase 13] corpus {json.dumps(out['corpus'])}")
    processed = workdir / "data" / "processed"
    edges = load_edges(processed / "graph_edges.csv")
    num_items = json.loads((processed / "split_info.json").read_text())["num_items"]
    splits = {name: SessionDataset(str(processed / f"{name}.csv"), edges, num_items=num_items)
              for name in ("train", "val", "test")}
    training, out["split_info"] = quickstart_training(processed, workdir, splits["val"])
    out.update(training)
    log(f"[phase 13] train_baseline (defaults) {json.dumps(out['train'])}")
    log(f"[phase 13] train_baseline --lazy-adamw --batch-size 512 {json.dumps(out['lazy'])}")
    out.update(quickstart_evaluation(processed, workdir))
    for key in ("eval_eager", "eval_lazy", "gate"):
        log(f"[phase 13] {key} {json.dumps(out[key])}")
    # Phase 17 exports (b)'s checkpoint_best: its parameters and buffers stay
    # (the optimizer's moments go); the rest, 1.47 GB a checkpoint, goes once read.
    kept = workdir / "eager" / QUICKSTART_MODEL / "checkpoint_best"
    (kept / checkpoint.OPTIMIZER_FILE).unlink()
    kept.rename(workdir / EXPORTED_CHECKPOINT)
    for label in ("eager", "lazy"):
        shutil.rmtree(workdir / label)
    out["pipeline"] = quickstart_pipeline(processed, workdir)
    log(f"[phase 13] run_full_pipeline {json.dumps(out['pipeline'])}")
    out["buckets"] = {**{name: buckets_filled(ds) for name, ds in splits.items()},
                      "pipeline": out["pipeline"]["buckets"]}
    log(f"[phase 13] node buckets filled, most sessions first: {json.dumps(out['buckets'])}")
    out["kernels"] = quickstart_kernels(gen, splits, out["pipeline"], sass)
    for name, row in out["kernels"].items():
        log(f"[phase 13] kernel {name} {json.dumps(row)}")
    out["seconds"] = time.perf_counter() - t0
    log(f"[phase 13] the Quickstart took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 14: what serving still lacked (the int8 scan, approx, chunk=, the
# dev and Vertex servers, the scoring bench)
# ---------------------------------------------------------------------------

SELECT_TOL = 1e-5  # kernel 2 against cuBLAS scores of the same float32 products
SERVER_REQUESTS = 200  # a server's HTTP latency: the latency bench's requests (2-11 items, k = 10)
SERVER_CHECKED = 50  # of which the first are held against the CPU copy of the model
BENCH_SCORING_STEPS = 10


def get(url: str) -> tuple[int, bytes, float]:
    t0 = time.perf_counter()
    with urllib.request.urlopen(url, timeout=120) as r:
        return r.status, r.read(), (time.perf_counter() - t0) * 1e3


@contextlib.contextmanager
def serving(server):
    """`server` answering on its own thread; shut down and joined on exit."""
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        if thread.is_alive():
            raise AssertionError("a server thread did not stop")


def percentiles(ms: list) -> dict:
    return {"p50": float(np.percentile(ms, 50)), "p95": float(np.percentile(ms, 95)),
            "p99": float(np.percentile(ms, 99)), "n": len(ms)}


def serve_int8(workdir: Path, rng: np.random.Generator) -> tuple[dict, dict]:
    """Phase 4's requests over HTTP through Recommender(int8_scoring=True) on
    the card (the forward on the card, the int8 scan and the float32 re-rank
    on the host), counted: 2 attention launches a request and no scoring
    launch. Each request's top 10 against the exact path's (kernel 2) on the
    card, near-ties aside; then the latency of both modes over the latency
    bench's 200 requests."""
    int8 = Recommender(workdir / "ckpt", workdir / "graph_edges.csv", device="cuda", int8_scoring=True)
    exact = Recommender(workdir / "ckpt", workdir / "graph_edges.csv", device="cuda", int8_scoring=False)
    if not int8.health()["int8_scoring"] or exact.health()["int8_scoring"]:
        raise AssertionError(f"health() does not report the scoring path: {int8.health()}, {exact.health()}")
    sessions = make_sessions(rng)
    app.set_recommender(int8)
    answers = []
    reset_launch_counts()
    try:
        with serving(app.make_server("127.0.0.1", 0, load_model=False)) as url:
            for items, k in sessions:
                status, payload, _ = post(f"{url}/recommend", {"session_items": items, "k": k})
                if status != 200 or len(payload["recommendations"]) != k:
                    raise AssertionError(f"int8 serving: HTTP {status} {payload}")
                answers.append((payload["recommendations"], payload["scores"]))
    finally:
        app.set_recommender(None)
    launches = expect_counts("int8 serving", session_attention=2 * len(sessions))
    same_ids = 0
    for (items, k), (ids, scores) in zip(sessions, answers):
        want = exact.recommend(validate_request(_Req(items, k), NUM_ITEMS))
        top = min(k, 10)
        agree((ids[:top], scores[:top]), (want[0][:top], want[1][:top]))
        same_ids += ids == want[0]
        if set(ids) & set(items) or 0 in ids or max(ids) >= NUM_ITEMS:
            raise AssertionError("int8 serving recommended a seen, padding or phantom item")
    requests = latency_bench.make_requests(NUM_ITEMS, 200)
    latency = {mode: latency_bench.measure(rec, requests) for mode, rec in (("int8", int8), ("exact", exact))}
    return {"requests": len(sessions), "top10_equal_exact": True,
            "whole_k_equal_exact": f"{same_ids} of {len(sessions)}", "latency_ms": latency,
            "n_threads": 2, "candidates": 1024}, launches


def selection_paths(workdir: Path, gen: torch.Generator) -> tuple[dict, dict]:
    """approx at B = 1 (with the serving mask) and B = 512 against the exact
    path (ids equal: the same kernel scores), then two_level_topk at chunks
    8, 16 and 64 against chunk 32 (ids equal but where the two scores,
    kernel 2's and cuBLAS's, tie within SELECT_TOL), each path counted, and
    each timed eagerly (CUDA events, host dispatch included)."""
    model = create_model("graph_transformer_optimized", NUM_ITEMS, device="meta")
    table = checkpoint.restore_params_state(workdir / "ckpt", model, "cuda").item_embedding.detach()
    exclude = torch.zeros(table.shape[0], dtype=torch.uint8, device=table.device)
    exclude[torch.randint(1, NUM_ITEMS, (10,), device=table.device, generator=gen)] = 1
    exclude[0] = 1
    out, launches = {}, {}
    for B in (1, TRAIN_BATCH):
        sess = torch.randn(B, DIM, device=table.device, generator=gen)
        mask = exclude if B == 1 else None
        exact = full_catalog_topk(sess, table, 20, NUM_ITEMS, exclude=mask)
        reset_launch_counts()
        approx = full_catalog_topk(sess, table, 20, NUM_ITEMS, method="approx", exclude=mask)
        launches[f"approx_B{B}"] = expect_counts(f"approx at B={B}", score_chunkmax=1)
        if not (torch.equal(approx[1], exact[1]) and torch.equal(approx[0], exact[0])):
            raise AssertionError(f"approx at B={B}: ids differ from the exact path's")
        if B == 1:  # a table off the 32-row chunk: kernel 2 on a padded copy
            reset_launch_counts()
            off = full_catalog_topk(sess, table[:NUM_ITEMS], 20, exclude=exclude[:NUM_ITEMS])
            expect_counts("two_level_topk on a table off the chunk", score_chunkmax=1)
            if not (torch.equal(off[1], exact[1]) and torch.equal(off[0], exact[0])):
                raise AssertionError("two_level_topk on a table off the chunk differs from the padded table's")
            off_chunk_ms = eager_ms(lambda: full_catalog_topk(sess, table[:NUM_ITEMS], 20,
                                                              exclude=exclude[:NUM_ITEMS]), 10)
        reset_launch_counts()
        chunk32 = two_level_topk(sess, table, 20, NUM_ITEMS, chunk=32, exclude=mask)
        launches[f"chunk32_B{B}"] = expect_counts(f"two_level_topk chunk 32 at B={B}", score_chunkmax=1)
        if not torch.equal(chunk32[1], exact[1]):
            raise AssertionError(f"two_level_topk chunk 32 at B={B} differs from full_catalog_topk")
        row = {"approx_ms": eager_ms(lambda: approx_topk(sess, table, 20, NUM_ITEMS, exclude=mask), 10),
               "exact_ms": eager_ms(lambda: full_catalog_topk(sess, table, 20, NUM_ITEMS, exclude=mask), 10),
               "ids_differing_near_ties": {}}
        if B == 1:
            row["exact_off_chunk_ms"] = off_chunk_ms
        reset_launch_counts()
        for chunk in (8, 16, 64):
            got = two_level_topk(sess, table, 20, NUM_ITEMS, chunk=chunk, exclude=mask)
            near_tie_agree(got, chunk32, tol=SELECT_TOL)
            row["ids_differing_near_ties"][chunk] = int((got[1] != chunk32[1]).sum())
            row[f"chunk{chunk}_ms"] = eager_ms(
                lambda: two_level_topk(sess, table, 20, NUM_ITEMS, chunk=chunk, exclude=mask), 10)
        expect_counts(f"two_level_topk chunks 8, 16, 64 at B={B}")  # the plain selection: no kernel
        out[f"B={B}"] = row
    approx_counts = {k: launches["approx_B1"][k] + launches[f"approx_B{TRAIN_BATCH}"][k] for k in launches["approx_B1"]}
    chunk_counts = {k: launches["chunk32_B1"][k] + launches[f"chunk32_B{TRAIN_BATCH}"][k] for k in launches["chunk32_B1"]}
    return out, {"approx": approx_counts, "two_level_chunk32": chunk_counts}


def scoring_bench() -> tuple[dict, dict]:
    """gat_recommendation_torch.scripts.bench_scoring once at its defaults
    (B = 512 over the full catalog, k = 20), BENCH_SCORING_STEPS steps a
    window, counted: kernel 2 once a step of each chunk-32 selector."""
    reset_launch_counts()
    result = bench_scoring.run(steps=BENCH_SCORING_STEPS, device="cuda")
    calls = 1 + 2 * max(BENCH_SCORING_STEPS // 5, 1) + BENCH_SCORING_STEPS  # warm-up, short and long windows
    launches = expect_counts("bench_scoring", score_chunkmax=3 * calls)  # two_level, nomask, approx
    torch.cuda.empty_cache()
    return result, launches


def mean_embedding_servers(workdir: Path) -> dict:
    """The dev and the Vertex-style server over HTTP on the card, on phase 4's
    checkpoint's table: every route of each (/health, /recommend,
    /recommend/batch; /predict, /metrics, /drift), the first SERVER_CHECKED
    answers against a CPU copy of the model, HTTP latency over
    SERVER_REQUESTS requests, then the dev model's p50 by stage in process;
    the no-op Metrics and the dataclass schemas where their packages are
    absent. The Vertex server's answers to the SERVER_REQUESTS requests are
    kept under "vertex_answers"."""
    model = dev_app.MeanEmbeddingModel.from_checkpoint(str(workdir / "ckpt"), device="cuda")
    cpu = dev_app.MeanEmbeddingModel(model.item_embeddings.cpu().numpy(), device="cpu")
    requests = latency_bench.make_requests(NUM_ITEMS, SERVER_REQUESTS)
    out = {"metrics_enabled": vertex_app.metrics.enabled, "pydantic": schemas.PYDANTIC,
           "request_schema": repr(schemas.RecommendRequest(session_items=[1, 2], k=3))}
    for name, server in (("dev", dev_app.make_server(model, "127.0.0.1", 0)),
                         ("vertex", vertex_app.make_server(model, "127.0.0.1", 0))):
        with serving(server) as url:
            status, body, _ = get(f"{url}/health")
            health = json.loads(body)
            if status != 200 or health["num_items"] != padded_rows(NUM_ITEMS) or health["embedding_dim"] != DIM:
                raise AssertionError(f"{name} /health: {status} {health}")
            ms, answers = [], []
            for r in requests:
                status, payload, t = post(f"{url}/recommend", {"session_items": r.session_items, "k": r.k})
                if status != 200:
                    raise AssertionError(f"{name} /recommend: {status} {payload}")
                answers.append((payload["recommendations"], payload["scores"]))
                ms.append(t)
            for r, answer in zip(requests[:SERVER_CHECKED], answers):  # after the timing: the CPU copy's threads
                agree(answer, cpu.recommend(r.session_items, r.k))
            if name == "vertex":
                out["vertex_answers"] = answers  # phase 17 serves the exported table against them
            batch = {"sessions": [r.session_items for r in requests[:4]] + [[10 ** 7]], "k": 5}
            status, payload, _ = post(f"{url}/recommend/batch", batch)
            results = payload["results"]
            if status != 200 or len(results) != 5 or "error" not in results[4] or \
                    any(len(x["recommendations"]) != 5 for x in results[:4]):
                raise AssertionError(f"{name} /recommend/batch: {status} {payload}")
            row = {"http_ms": percentiles(ms)}
            if name == "vertex":
                instances = [{"session_items": r.session_items, "k": 3} for r in requests[:3]] + [{"session_items": []}]
                status, payload, _ = post(f"{url}/predict", {"instances": instances})
                preds = payload["predictions"]
                if status != 200 or len(preds) != 4 or "error" not in preds[3] or \
                        any(len(p["recommendations"]) != 3 for p in preds[:3]):
                    raise AssertionError(f"vertex /predict: {status} {payload}")
                status, metrics_body, _ = get(f"{url}/metrics")
                if status != 200 or (not vertex_app.metrics.enabled and
                                     metrics_body != b"# prometheus_client not installed\n"):
                    raise AssertionError(f"vertex /metrics: {status} {metrics_body[:200]}")
                status, body, _ = get(f"{url}/drift")
                drift = json.loads(body)
                if status != 200 or drift["requests_seen"] != SERVER_REQUESTS + 4 + 3:
                    raise AssertionError(f"vertex /drift: {status} {drift}")
                row.update(metrics_bytes=len(metrics_body), drift=drift)
        out[name] = row
    out["dev_p50_by_stage_ms"] = recommend_stages(model, requests)
    return out


def recommend_stages(model, requests) -> dict:
    """p50 in ms, host clock, of MeanEmbeddingModel.recommend on the card
    called in process (no HTTP), and of its three stages, the same steps with
    the card synchronised after each: the session mean and the masked cosine
    scores of the whole catalog, the stable descending sort of those scores,
    and the top k's readback to the host. HTTP's share is the server's p50
    less the in-process one."""
    times: dict = {"in_process": [], "mean_and_scores": [], "stable_sort": [], "readback": []}
    for r in requests:
        t0 = time.perf_counter()
        model.recommend(r.session_items, r.k)  # ends in a readback
        t1 = time.perf_counter()
        idx = torch.tensor([i for i in r.session_items if 0 < i < model.num_items], device=model.device)
        sess = model.item_embeddings[idx].mean(dim=0)
        scores = model._normed @ (sess / torch.linalg.vector_norm(sess).clamp_min(1e-12))
        scores[idx] = -torch.inf
        scores[0] = -torch.inf
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        top = torch.sort(scores, descending=True, stable=True).indices[:r.k]
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        top.tolist(), scores[top].tolist()
        t4 = time.perf_counter()
        for key, a, b in (("in_process", t0, t1), ("mean_and_scores", t1, t2), ("stable_sort", t2, t3),
                          ("readback", t3, t4)):
            times[key].append((b - a) * 1e3)
    return {key: float(np.percentile(ms, 50)) for key, ms in times.items()}


def serving_rest(gen: torch.Generator) -> tuple[dict, dict]:
    """Phase 14 in a temporary directory holding phase 4's checkpoint and
    edges again (the same seeds)."""
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        workdir = Path(tmp)
        t0 = time.perf_counter()
        rng = np.random.default_rng(0)
        make_checkpoint(workdir / "ckpt")
        make_edges(workdir / "graph_edges.csv", rng)
        out["int8"], int8_launches = serve_int8(workdir, rng)
        log(f"[phase 14] int8 serving {json.dumps(out['int8'])}")
        torch.cuda.empty_cache()
        out["selection"], selection_launches = selection_paths(workdir, gen)
        log(f"[phase 14] approx and two_level_topk by chunk {json.dumps(out['selection'])}")
        out["servers"] = mean_embedding_servers(workdir)
        out["vertex_answers"] = out["servers"].pop("vertex_answers")
        log(f"[phase 14] dev and Vertex servers {json.dumps(out['servers'])}")
    torch.cuda.empty_cache()
    out["bench_scoring"], bench_launches = scoring_bench()
    log(f"[phase 14] bench_scoring {json.dumps(out['bench_scoring'])}")
    out["seconds"] = time.perf_counter() - t0
    log(f"[phase 14] took {out['seconds']:.1f} s")
    return out, {"serving_int8": int8_launches, **selection_launches, "bench_scoring": bench_launches}


# ---------------------------------------------------------------------------
# Phase 15: the study and tool scripts, and the bit-packed adjacency
# ---------------------------------------------------------------------------

# The probe's corpus: small, all four families at D = 256 (the trainers' widths),
# two epochs; the ablations: one of configs/ablations.yaml, one epoch.
DISCRIMINATION_ITEMS = 30_000
DISCRIMINATION = ["--num-sessions", "4000", "--num-items", str(DISCRIMINATION_ITEMS), "--num-active", "3000",
                  "--num-clusters", "30", "--max-epochs", "2", "--patience", "2"]
ABLATION_SUBSET = ["loss_bpr"]
BENCH_ATTENTION_STEPS = 50
YOOCHOOSE_CLICKS, YOOCHOOSE_BUYS = 200_000, 20_000


def sr_checks() -> tuple[dict, dict]:
    """(a) scripts.pipeline.validate_sr_onchip: its three checks on the card,
    counted (2 + 1 + 2,000 sparse AdamW launches)."""
    reset_launch_counts()
    t0 = time.perf_counter()
    out = validate_sr_onchip.main([])
    out["seconds"] = time.perf_counter() - t0
    return out, expect_counts("validate_sr_onchip", sparse_adamw=3 + validate_sr_onchip.STEPS)


def attention_bench() -> tuple[list, dict]:
    """(b) scripts.bench_attention at B = 512, every bucket: the eval forward
    with kernel 1 reading the packed rows against the plain attention."""
    reset_launch_counts()
    rows = bench_attention.main(["--steps", str(BENCH_ATTENTION_STEPS)])
    counts = launch_counts()
    if counts["session_attention"] < 1 or counts["session_attention_packed"] != counts["session_attention"] \
            or counts["session_attention_backward"] or not all(r["adj_packed"] for r in rows):
        raise AssertionError(f"bench_attention: every forward must read the packed rows: {counts}")
    if not all(np.isfinite(r["kernel_ms"]) and r["kernel_ms"] > 0 for r in rows):
        raise AssertionError(f"bench_attention: {rows}")
    return rows, counts


def discrimination_probe(workdir: Path) -> tuple[dict, dict]:
    """(c) scripts.pipeline.corpus_discrimination on a small corpus, the four
    families at D = 256 for two epochs on the card (eager sparse step, chain
    16): a finite best recall@10 a model, the order and every pair's margin;
    kernel 1 (packed rows: every launch), 2, 3 and node dropout launched."""
    reset_launch_counts()
    t0 = time.perf_counter()
    out = corpus_discrimination.main([*DISCRIMINATION, "--output-dir", str(workdir / "discrimination")])
    counts = launch_counts()
    models = out["models"]
    if list(models) != ["graph_transformer_optimized", "graph_transformer", "gat", "graphsage"] or \
            not all(0.0 <= m["best_recall@10"] <= 1.0 and m["epochs_run"] == 2 for m in models.values()) or \
            len(out["pairwise_margins"]) != 6:
        raise AssertionError(f"corpus_discrimination: {out}")
    if min(counts[k] for k in ("session_attention", "session_attention_backward", "sparse_adamw",
                                "score_chunkmax", "node_dropout")) < 1 or counts["embedding_adamw"] or \
            counts["session_attention_packed"] != counts["session_attention"] or \
            counts["session_attention_backward_packed"] != counts["session_attention_backward"]:
        raise AssertionError(f"corpus_discrimination launches: {counts}")
    return {"seconds": time.perf_counter() - t0, "baselines": out["baselines"], "order": out["order"],
            "models": {k: {f: v[f] for f in ("best_recall@10", "ci95", "best_epoch", "seconds")}
                       for k, v in models.items()},
            "unresolved_pairs": out["unresolved_pairs"]}, counts


def ablations(processed: Path, workdir: Path) -> tuple[dict, dict]:
    """(d) scripts.train.run_ablations on corpus v3 (phase 13's files), the
    ABLATION_SUBSET of configs/ablations.yaml for one epoch at full width: the dense
    step, so kernel 4 once a step, with kernels 1 (packed rows) and 2."""
    reset_launch_counts()
    t0 = time.perf_counter()
    argv = ["--config", str(REPO / "configs" / "ablations.yaml"), "--ablations", *ABLATION_SUBSET,
            "--train-sessions", str(processed / "train.csv"), "--val-sessions", str(processed / "val.csv"),
            "--graph-edges", str(processed / "graph_edges.csv"), "--max-epochs", "1",
            "--results-file", str(workdir / "ablation_results.json")]
    with contextlib.chdir(workdir):  # its checkpoints go to outputs/ablations/<name> where it runs
        out = run_ablations.main(argv)
    shutil.rmtree(workdir / "outputs", ignore_errors=True)
    counts = launch_counts()
    if list(out) != ABLATION_SUBSET or not all(0.0 <= r["recall@10"] <= 1.0 for r in out.values()):
        raise AssertionError(f"run_ablations: {out}")
    if min(counts[k] for k in ("embedding_adamw", "session_attention", "session_attention_backward",
                                "score_chunkmax", "node_dropout")) < 1 or counts["sparse_adamw"] or \
            counts["session_attention_packed"] != counts["session_attention"]:
        raise AssertionError(f"run_ablations launches: {counts}")
    return {"seconds": time.perf_counter() - t0,
            "results": {k: {m: v[m] for m in ("recall@10", "ndcg@10", "seconds")} for k, v in out.items()}}, counts


def yoochoose(workdir: Path) -> dict:
    """(e) scripts.data.convert_yoochoose on clicks and buys written in
    YooChoose's format: every event written, in time order, in epoch ms."""
    rng = np.random.default_rng(15)
    base = np.datetime64("2014-04-01T00:00:00.000")
    clicks, buys = workdir / "yoochoose-clicks.dat", workdir / "yoochoose-buys.dat"
    for path, n, tail in ((clicks, YOOCHOOSE_CLICKS, lambda m: rng.integers(0, 12, m).astype(str)),
                          (buys, YOOCHOOSE_BUYS, lambda m: np.char.add(rng.integers(0, 5000, m).astype(str),
                                                                         ",1"))):
        ts = base + rng.integers(0, 180 * 86_400_000, n).astype("timedelta64[ms]")
        lines = np.char.add(np.char.add(np.char.add(rng.integers(1, 50_000, n).astype(str), ","),
                                        np.char.add(ts.astype(str), "Z,")),
                            np.char.add(np.char.add(rng.integers(214_500_000, 214_600_000, n).astype(str), ","),
                                        tail(n)))
        path.write_text("\n".join(lines.tolist()) + "\n")
    t0 = time.perf_counter()
    if convert_yoochoose.main(["--clicks-file", str(clicks), "--buys-file", str(buys),
                               "--output-file", str(workdir / "events.csv")]) != 0:
        raise AssertionError("convert_yoochoose failed")
    seconds = time.perf_counter() - t0
    events = read_csv(workdir / "events.csv")
    ts = events["timestamp"]
    if len(ts) != YOOCHOOSE_CLICKS + YOOCHOOSE_BUYS or np.any(np.diff(ts) < 0) or \
            not 1_396_310_400_000 <= ts[0] < 1_396_310_400_000 + 180 * 86_400_000 or \
            int(np.sum(events["event"] == "transaction")) != YOOCHOOSE_BUYS:
        raise AssertionError("convert_yoochoose: the events are not all there, in time order, in epoch ms")
    return {"events": len(ts), "seconds": seconds}


def packed_transfer(bench_results: list, counted: dict[str, dict]) -> dict:
    """(g) the paths that copy batches to the card read the packed rows in
    every kernel 1 launch (phase 11's bench, phase 8's and 13's trainers);
    serving's never. Phase 11's T32 and T1 sessions a second beside."""
    for path, counts in counted.items():
        want = (0, 0) if path.startswith(("serving", "latency", "zoo_serving")) else (
            counts["session_attention"], counts["session_attention_backward"])
        got = (counts["session_attention_packed"], counts["session_attention_backward_packed"])
        if got != want or (want != (0, 0) and counts["session_attention"] < 1):
            raise AssertionError(f"{path}: packed kernel 1 launches {got}, want {want}: {counts}")
    return {"checked_paths": sorted(counted),
            "bench_sessions_per_s": {f"chain {c} workers {w}/{tw}": r["value"]
                                     for (c, w, tw), r in zip(BENCH_RUNS, bench_results)}}


def studies_and_packing(gen: torch.Generator, processed: Path, bench_results: list,
                        counted: dict[str, dict]) -> tuple[dict, dict]:
    """Phase 15: (a)-(g); returns the results and each path's launch counts."""
    out: dict = {}
    t0 = time.perf_counter()
    # (f) the packed route at the shapes of (b) (the eval forward at B = 512)
    # and (c) (B = 128, the two Graph Transformers' 2 and 4 heads), every bucket
    out["bench_attention_rows"] = [check_attention(TRAIN_BATCH, N, gen, packed=True) for N in BUCKETS]
    for row in out["bench_attention_rows"]:
        log(f"[phase 15] (f) session_attention {json.dumps(row)}")
    out["probe_attention"] = [check_attention_training(128, N, DROPOUT, gen, heads=h, packed=True)
                              for h in (HEADS, ZOO_HEADS) for N in BUCKETS]
    for row in out["probe_attention"]:
        for part, r in row.items():
            log(f"[phase 15] (f) session_attention {part} {json.dumps(r)}")
    out["sr_adamw"] = check_sparse_adamw(gen, torch.bfloat16, True, U=64, n_unique=2, rows=2 * validate_sr_onchip.TILE)
    out["probe_adamw"] = check_sparse_adamw(gen, torch.float32, False, U=2048, n_unique=1500,
                                            rows=padded_rows(DISCRIMINATION_ITEMS))
    out["probe_score"] = check_scoring(gen, 128, num_items=DISCRIMINATION_ITEMS)
    for key in ("sr_adamw", "probe_adamw", "probe_score"):
        log(f"[phase 15] {key} {json.dumps(out[key])}")
    torch.cuda.empty_cache()
    launches = {}
    out["sr"], launches["validate_sr_onchip"] = sr_checks()
    log(f"[phase 15] (a) validate_sr_onchip {json.dumps(out['sr'])}")
    out["bench_attention"], launches["bench_attention"] = attention_bench()
    log(f"[phase 15] (b) bench_attention {json.dumps(out['bench_attention'])}")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out["discrimination"], launches["corpus_discrimination"] = discrimination_probe(Path(tmp))
    log(f"[phase 15] (c) corpus_discrimination {json.dumps(out['discrimination'])}")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out["ablations"], launches["run_ablations"] = ablations(processed, Path(tmp))
        log(f"[phase 15] (d) run_ablations {json.dumps(out['ablations'])}")
        out["yoochoose"] = yoochoose(Path(tmp))
    log(f"[phase 15] (e) convert_yoochoose {json.dumps(out['yoochoose'])}")
    out["transfer"] = packed_transfer(bench_results, {**counted, **launches})
    log(f"[phase 15] (g) packed transfer {json.dumps(out['transfer'])}")
    out["seconds"] = time.perf_counter() - t0
    log(f"[phase 15] took {out['seconds']:.1f} s")
    return out, launches


# ---- phase 16: the mesh ----

MESH_N_MODELS = (1, 2, 4, 8)
MESH_TRAIN_STEPS, MESH_VAL_BATCHES = 4, 2  # batches of 512 a Trainer run in (b)
MESH_TOL = dict(loss_rtol=1e-5, weight_atol=1e-6)  # the CPU tests' tolerances
# (d): the chain of train_baseline's default, over an epoch of phase 11's corpus
# (its smallest bucket holds a full group and a partial one); evaluated batches.
MESH_CHAIN, MESH_CHAIN_VAL_BATCHES = 32, 3
NCCL_CAPTURE_MIN = (2, 9, 6)  # the first NCCL release that a CUDA graph may capture


def check_sharded_sparse_adamw(gen: torch.Generator, moment_dtype: torch.dtype, stochastic: bool,
                               U: int = 16384, n_unique: int = 12000) -> list[dict]:
    """(a) B1 at full width: the table in 1, 2, 4 and 8 row shards, views of
    one table in one process, each shard through ``sharded_sparse_adamw`` at
    counts 1, 2, 3. The shards put together EQUAL one kernel 3 call over the
    whole table (table and moments); against the plain twin the table within
    TABLE_TOL and the moments bit-equal. One row a shard: kernel ms (a graph
    of 20 calls, median of 10 replays) and eager ms, the library call's ms
    alike, the plain twin's from a graph of 2 calls, median of 3 (54 ms a
    call at bf16+SR), and the bound of the shard's bytes."""
    dev = torch.device("cuda")
    table, mu, nu = _table_state(gen, moment_dtype)
    ids = torch.randperm(NUM_ITEMS - 1, device=dev, generator=gen)[: n_unique - 1] + 1
    uid = torch.full((U,), 2**31 - 1, dtype=torch.int32, device=dev)
    uid[:n_unique] = torch.cat([torch.zeros(1, device=dev, dtype=torch.long), ids.sort().values]).int()
    summed = 1e-3 * torch.randn(U, DIM, device=dev, generator=gen)
    summed[0] = 0.0
    summed[n_unique:] = 0.0
    whole = [t.clone() for t in (table, mu, nu)]
    for count in (1, 2, 3):
        sparse_adamw(*whole, uid, summed, count, stochastic_rounding=stochastic, **ADAMW)
    m_bytes = 2 if moment_dtype == torch.bfloat16 else 4
    label = f"{str(moment_dtype).split('.')[-1]}{'+sr' if stochastic else ''}"
    row3, rows = step_row(3), []
    for n in MESH_N_MODELS:
        per = ROWS // n
        got = [t.clone() for t in (table, mu, nu)]
        want = [t.clone() for t in (table, mu, nu)]
        for count in (1, 2, 3):
            for s in range(n):
                sl = slice(s * per, (s + 1) * per)
                sharded_sparse_adamw(*(t[sl] for t in got), uid, summed, count, shard=s, n_shards=n,
                                     stochastic_rounding=stochastic, **ADAMW)
                sharded_sparse_adamw_reference(*(t[sl] for t in want), uid, summed, count, shard=s, n_shards=n,
                                               stochastic_rounding=stochastic, **ADAMW)
        torch.cuda.synchronize()
        if not all(_same_bits(a, b) for a, b in zip(got, whole)):
            raise AssertionError(f"sharded_sparse_adamw: {n} shards differ from one kernel 3 call ({label})")
        torch.testing.assert_close(got[0], want[0], **TABLE_TOL)
        if not (_same_bits(got[1], want[1]) and _same_bits(got[2], want[2])):
            raise AssertionError(f"sharded_sparse_adamw: {n} shards' moments differ from the plain twin ({label})")
        err = (got[0] - want[0]).abs().max().item()
        for s in range(n):
            lo, hi = s * per, (s + 1) * per
            sl = slice(lo, hi)
            mine = (uid[:n_unique] >= lo) & (uid[:n_unique] < hi)
            n_mine = int(mine.sum())
            bound, bound_by = bound_ms(2 * per * DIM * (4 + 2 * m_bytes) + 4 * U + 4 * n_mine * DIM, 14 * per * DIM)
            grad = torch.zeros(per, DIM, device=dev)
            local = uid[:n_unique][mine].long() - lo
            rows_mine = summed[:n_unique][mine]

            def scatter(grad=grad, local=local, rows_mine=rows_mine):
                grad.zero_()
                grad.index_add_(0, local, rows_mine)

            views = [t[sl] for t in got]
            plain = [t[sl].clone() for t in want]

            def kernel(views=views, s=s, n=n):
                sharded_sparse_adamw(*views, uid, summed, row3, shard=s, n_shards=n,
                                     stochastic_rounding=stochastic, **ADAMW)

            library = _fused_adamw_library(*[t[sl].clone() for t in (table, mu, nu)], grad, scatter)
            rows.append({
                "shape": f"V={ROWS} D={DIM} U={U} unique={n_unique} moments={label} n_model={n} shard={s} "
                         f"rows={per} own={n_mine}",
                "n_model": n, "shard": s, "max_abs_err": err,
                "ms": device_ms(kernel), "eager_ms": eager_ms(kernel, 10),
                "plain_ms": device_ms(lambda plain=plain, s=s, n=n: sharded_sparse_adamw_reference(
                    *plain, uid, summed, 3, shard=s, n_shards=n, stochastic_rounding=stochastic, **ADAMW), 2, 3),
                "library_ms": None if library is None else device_ms(library),
                "bound_ms": bound, "bound_by": bound_by,
            })
        del got, want
        torch.cuda.empty_cache()
    return rows


def join_nccl_group_of_one():
    """The 1x1 mesh: a process group of this process alone over NCCL, on
    127.0.0.1 and a free port given as torchrun would give them. No fallback:
    a group that does not come up, or not on nccl, fails the phase."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(distributed.free_port()), WORLD_SIZE="1",
                      RANK="0", LOCAL_RANK="0")
    if not distributed.initialize(device="cuda"):
        raise AssertionError("phase 16: the launch variables did not start a process group")
    if torch.distributed.get_backend() != "nccl":
        raise AssertionError(f"phase 16: the group runs on {torch.distributed.get_backend()}, not nccl")
    return make_mesh(1, 1)


def _state_of(t: Trainer) -> dict:
    return {**t.model.state_dict(), **t.optimizer.export_state(t.opt_state, t.model)}


def dropout_masks_under_the_mesh(mesh, model, batch: SessionBatch, row: torch.Tensor) -> dict:
    """The keep bits of one train step's dropouts, node and attention, at the
    batch's shapes, with the mesh's shard active against without it (EQUAL),
    and of two data ranks' halves of the batch, each at its first session,
    against the whole batch's draw at those rows (EQUAL)."""
    B, N = batch.node_ids.shape
    dev = torch.device("cuda")
    seeds = step_block.layer_seeds(row, 0, model.seeds_per_layer)
    ones = torch.ones(B, N, DIM, device=dev)
    q = torch.zeros(B, N, DIM, device=dev)
    adj = batch.adj
    whole_node = node_dropout(ones, DROPOUT, seeds[1])
    whole_attn = session_attention(q, q, ones, adj, HEADS, DROPOUT, seeds[0], packed=batch.adj_packed)
    with shard.active(active_shard(model, mesh, B)):
        mesh_node = node_dropout(ones, DROPOUT, seeds[1])
        mesh_attn = session_attention(q, q, ones, adj, HEADS, DROPOUT, seeds[0], packed=batch.adj_packed)
    halves = []
    for lo, hi in ((0, B // 2), (B // 2, B)):
        with shard.active(shard.Shard(first_session=lo)):
            halves.append((node_dropout(ones[lo:hi], DROPOUT, seeds[1]),
                           session_attention(q[lo:hi], q[lo:hi], ones[lo:hi], adj[lo:hi], HEADS, DROPOUT, seeds[0],
                                             packed=batch.adj_packed)))
    torch.cuda.synchronize()
    out = {"node_equal": torch.equal(mesh_node, whole_node), "attention_equal": torch.equal(mesh_attn, whole_attn),
           "halves_node_equal": torch.equal(torch.cat([h[0] for h in halves]), whole_node),
           "halves_attention_kept_equal": torch.equal(torch.cat([h[1] for h in halves]) != 0, whole_attn != 0),
           "node_kept_share": (whole_node != 0).float().mean().item()}
    if not all(v for k, v in out.items() if k != "node_kept_share"):
        raise AssertionError(f"phase 16: dropout masks differ under the mesh: {out}")
    return out


def mesh_against_one_gpu(mesh, epoch: list, workdir: Path) -> tuple[dict, dict]:
    """(b) Trainers at full width (the optimized Graph Transformer, 466,865
    items, D = 256, batch 512, dropout 0.1) on the 1x1 mesh against the
    single-GPU Trainer from the same seeded weights and batches: an epoch of
    MESH_TRAIN_STEPS lazy steps, then eager steps (B1), then dense steps
    (kernel 4 on the shard), each with materialize and an evaluation of
    MESH_VAL_BATCHES batches. Held: the epoch loss (1e-5), every tensor of
    the state (1e-6), the metrics and the first batch's top-k ids equal, the
    dropout masks equal; the lazy mesh run saved and loaded on one GPU.
    Returns the results and the mesh runs' launches (counted from 0 before
    each mesh run)."""
    dev = torch.device("cuda")
    train, val = epoch[:MESH_TRAIN_STEPS], epoch[MESH_TRAIN_STEPS:MESH_TRAIN_STEPS + MESH_VAL_BATCHES]
    out, launches = {}, {}
    for kind in ("lazy", "eager", "dense"):
        runs = {}
        for label, m in (("one_gpu", None), ("mesh", mesh)):
            t = Trainer(make_training_model(DROPOUT), lambda e: iter(train), lambda: iter(val),
                        optimizer=FusedEmbeddingAdamW(1e-3, weight_decay=1e-5, lazy=kind == "lazy"),
                        output_dir=workdir / f"{kind}_{label}", loss_fn=create_loss_function("dual"),
                        sparse_embedding_grads=kind != "dense", device="cuda", mesh=m)
            t.init_state(reset_parameters=False)
            if m is not None:
                reset_launch_counts()
            t0 = time.perf_counter()
            loss = t.train_epoch()
            metrics = t.evaluate()
            tops = t._eval_step(to_device(val[0], dev))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            if m is not None:
                launches = {k: launches.get(k, 0) + v for k, v in launch_counts().items()}
            runs[label] = (t, loss, metrics, tops, seconds)
        (one, loss1, metrics1, tops1, s1), (mesh_t, loss2, metrics2, tops2, s2) = runs["one_gpu"], runs["mesh"]
        if abs(loss2 - loss1) > MESH_TOL["loss_rtol"] * abs(loss1):
            raise AssertionError(f"phase 16 {kind}: mesh loss {loss2} against one GPU's {loss1}")
        a, b = _state_of(mesh_t), _state_of(one)
        diff = max((a[k].float() - b[k].float()).abs().max().item() for k in b)
        if diff > MESH_TOL["weight_atol"] or metrics1 != metrics2 or not torch.equal(tops1, tops2):
            raise AssertionError(f"phase 16 {kind}: mesh against one GPU: state {diff}, metrics {metrics2} / "
                                 f"{metrics1}, ids equal {torch.equal(tops1, tops2)}")
        out[kind] = {"loss_mesh": loss2, "loss_one_gpu": loss1, "max_state_diff": diff, "metrics": metrics2,
                     "ids_equal": True, "seconds_mesh": s2, "seconds_one_gpu": s1}
        if kind == "lazy":
            batch = to_device(train[0], dev)
            row = next_steps_block(one.model, one.optimizer, one.opt_state, [one.step_seed(0)], dev)[0]
            out["dropout_masks"] = dropout_masks_under_the_mesh(mesh, mesh_t.model, batch, row)
            mesh_t.save_checkpoint("latest")
            reader = Trainer(make_training_model(DROPOUT), lambda e: iter(()), lambda: iter(()),
                             optimizer=FusedEmbeddingAdamW(1e-3, weight_decay=1e-5, lazy=True),
                             output_dir=workdir / "lazy_mesh", sparse_embedding_grads=True, device="cuda")
            reader.load_checkpoint("latest")
            loaded = _state_of(reader)
            same = all(torch.equal(loaded[k], v) for k, v in _state_of(mesh_t).items())
            if not same or reader.current_epoch != 1:
                raise AssertionError("phase 16: the mesh's checkpoint did not load on one GPU as saved")
            out["checkpoint"] = {"loaded_on_one_gpu_equal": True, "log": mesh_t.checkpoint_log + reader.checkpoint_log}
            del reader, loaded
        del runs, one, mesh_t, a, b
        torch.cuda.empty_cache()
    return out, launches


def bench_over_the_mesh() -> tuple[list, dict]:
    """(c) the bench at BENCH_SESSIONS sessions, chain 1, lazy, 3/3 threads,
    ``--mesh 1x1`` (the sharded step on the 1x1 NCCL mesh), then without the
    mesh, each with one traced epoch (the device's busy seconds and idle
    share). Returns the results and the launches of the mesh run (counted
    from 0)."""
    results, launches = [], None
    for mesh_shape in ((1, 1), None):
        reset_launch_counts()
        result = bench.main_e2e(BENCH_SESSIONS, 3, BENCH_EPOCHS, 1, lazy=True, transfer_workers=3,
                                mesh_shape=mesh_shape, profile=True)
        if launches is None:
            launches = launch_counts()
        if not (np.isfinite(result["value"]) and result["value"] > 0):
            raise AssertionError(f"phase 16 bench: {result}")
        if mesh_shape is not None and result["_detail"]["mesh"] != "1x1":
            raise AssertionError(f"phase 16 bench --mesh 1x1 did not run the sharded path: {result['_detail']}")
        results.append(result)
        torch.cuda.empty_cache()
    if launches["lazy_gather_catch_up"] < 1:
        raise AssertionError(f"phase 16 bench --mesh 1x1 launched no lazy gather: {launches}")
    return results, launches


def mesh_chain_epoch() -> tuple[list, list, dict]:
    """(d)'s batches: one shuffled epoch of phase 11's corpus (the bench's
    BENCH_SESSIONS sessions over the full catalog, batches of 512 from the
    C++ engine), MESH_CHAIN_VAL_BATCHES of them to evaluate, and the batches
    of each node bucket. The smallest bucket must hold a full group of
    MESH_CHAIN and a partial group with a sub-chain."""
    t0 = time.perf_counter()
    dataset, _ = bench.make_corpus(BENCH_SESSIONS)
    epoch = list(iterate_batches(dataset, TRAIN_BATCH, shuffle=True, seed=0))
    counts = {n: sum(b.nodes_per_session == n for b in epoch) for n in sorted({b.nodes_per_session for b in epoch})}
    if counts[8] < MESH_CHAIN + SUBCHAIN:
        raise AssertionError(f"phase 16 (d): the buckets {counts} hold no full group of {MESH_CHAIN} and sub-chain")
    val = [b for b in epoch if b.nodes_per_session == 8][:MESH_CHAIN_VAL_BATCHES - 1] + \
        [b for b in epoch if b.nodes_per_session != 8][:1]
    log(f"[phase 16] (d) {len(dataset)} sessions, {len(epoch)} batches of {TRAIN_BATCH} by bucket {counts}, "
        f"assembled in {time.perf_counter() - t0:.1f} s")
    return epoch, val, counts


def chained_dispatches_of(counts: dict, chain: int) -> int:
    """The chained dispatches of an epoch with `counts` batches a node bucket:
    each full group, then each SUBCHAIN run of a partial group (chain > SUBCHAIN)."""
    return sum(c // chain + (c % chain) // SUBCHAIN * (chain > SUBCHAIN) for c in counts.values())


def chained_mesh_against_unchained(mesh, epoch: list, val: list, counts: dict, workdir: Path) -> tuple[dict, dict]:
    """(d) Trainers at full width (the optimized Graph Transformer, 466,865
    items, D = 256, batch 512, dropout 0.1), lazy and eager (B1): the 1x1
    NCCL mesh at chain MESH_CHAIN against the mesh at chain 1 and against
    the single-GPU Trainer at chain MESH_CHAIN, from the same seeded weights
    and batches: an epoch, then an evaluation (unchained under the mesh).
    Held EQUAL: the epoch loss, every tensor of the state, the metrics and
    the first evaluated batch's top-k ids. The chained mesh runs are counted
    from 0 (through the graph replays: per step 2 attention forward and 2
    backward, 4 node dropout, and 1 gather and 1 touched update, or 1 B1;
    per evaluated batch 2 forward and 1 scoring; per evaluation 1
    materialize), their chained dispatches must be the epoch's full groups
    and sub-chains, and their graphs (with the NCCL collectives inside) must
    have been captured. Returns the results and the counted launches."""
    dev = torch.device("cuda")
    nccl = torch.cuda.nccl.version()
    if tuple(nccl) < NCCL_CAPTURE_MIN:
        raise AssertionError(f"phase 16 (d): NCCL {nccl} cannot be captured in a CUDA graph (from {NCCL_CAPTURE_MIN})")
    want_dispatches = chained_dispatches_of(counts, MESH_CHAIN)
    n_steps, n_val = len(epoch), len(val)
    out, launches = {"nccl_version": ".".join(map(str, nccl)), "chain": MESH_CHAIN, "steps": n_steps,
                     "val_batches": n_val, "buckets": counts}, {}
    for kind in ("lazy", "eager"):
        runs = {}
        for label, m, chain in (("mesh_chained", mesh, MESH_CHAIN), ("mesh_chain_1", mesh, 1),
                                ("one_gpu_chained", None, MESH_CHAIN)):
            t = Trainer(make_training_model(DROPOUT), lambda e: iter(epoch), lambda: iter(val),
                        optimizer=FusedEmbeddingAdamW(1e-3, weight_decay=1e-5, lazy=kind == "lazy"),
                        output_dir=workdir / f"{kind}_{label}", loss_fn=create_loss_function("dual"),
                        sparse_embedding_grads=True, chain=chain, device="cuda", mesh=m)
            t.init_state(reset_parameters=False)
            reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = t.train_epoch()
            metrics = t.evaluate()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            if label == "mesh_chained":
                table = dict(lazy_gather_catch_up=n_steps, lazy_touched_update=n_steps, lazy_materialize=1) \
                    if kind == "lazy" else dict(sharded_sparse_adamw=n_steps)
                got = expect_launches(f"phase 16 (d) {kind} chained mesh", session_attention=2 * (n_steps + n_val),
                                      session_attention_backward=2 * n_steps, score_chunkmax=n_val,
                                      node_dropout=4 * n_steps, **table)
                launches = {k: launches.get(k, 0) + v for k, v in got.items()}
                cache = t._chained_step.graphs
                if t.chained_dispatches != want_dispatches or not cache.graphs or t._chained_eval is not None:
                    raise AssertionError(f"phase 16 (d) {kind}: {t.chained_dispatches} chained dispatches (want "
                                         f"{want_dispatches}), {len(cache.graphs)} graphs, chained eval "
                                         f"{t._chained_eval is not None} (want none under the mesh)")
            tops = t._eval_step(to_device(val[0], dev))
            runs[label] = (t, loss, metrics, tops, seconds)
        chained_t, loss, metrics, tops, seconds = runs["mesh_chained"]
        row = {"loss": loss, "metrics": metrics, "chained_dispatches": chained_t.chained_dispatches,
               "graphs": _graph_stats(chained_t._chained_step.graphs),
               "seconds": {label: r[4] for label, r in runs.items()}}
        state = _state_of(chained_t)
        for label in ("mesh_chain_1", "one_gpu_chained"):
            other, loss2, metrics2, tops2, _ = runs[label]
            state2 = _state_of(other)
            differ = [k for k in state2 if not _bit_equal(state[k], state2[k])]
            if loss2 != loss or metrics2 != metrics or not torch.equal(tops, tops2) or differ or \
                    set(state) != set(state2):
                raise AssertionError(f"phase 16 (d) {kind}: the chained mesh run against {label}: loss {loss} / "
                                     f"{loss2}, metrics {metrics} / {metrics2}, ids equal {torch.equal(tops, tops2)}, "
                                     f"state tensors that differ {differ}")
            row[f"equal_to_{label}"] = {"state_tensors": len(state2), "loss": loss2, "ids_equal": True}
        row["one_gpu_chained_dispatches"] = runs["one_gpu_chained"][0].chained_dispatches
        out[kind] = row
        del runs, chained_t, state, state2, other
        torch.cuda.empty_cache()
    return out, launches


def bench_chained_over_the_mesh() -> tuple[list, dict]:
    """(e) the bench at BENCH_SESSIONS sessions, chain MESH_CHAIN, lazy, 3/3
    threads, in turns ``--mesh 1x1`` (the chained sharded step on the 1x1
    NCCL mesh), without the mesh, without, with; the first pair with one
    traced epoch. The first mesh run is counted from 0 through the replays:
    per step 2 attention forward, 2 backward, 1 gather, 1 touched update, 4
    node dropout. Returns the four results and those launches."""
    results, launches = [], None
    for i, mesh_shape in enumerate(((1, 1), None, None, (1, 1))):
        reset_launch_counts()
        result = bench.main_e2e(BENCH_SESSIONS, 3, BENCH_EPOCHS, MESH_CHAIN, lazy=True, transfer_workers=3,
                                mesh_shape=mesh_shape, profile=i < 2)
        detail = result["_detail"]
        if launches is None:
            steps = detail["steps_per_epoch"] * (2 * BENCH_EPOCHS + 4)  # warm-up, short, long, traced
            launches = expect_launches(
                "phase 16 (e) bench --mesh 1x1 --chain 32", session_attention=2 * steps,
                session_attention_backward=2 * steps, lazy_gather_catch_up=steps, lazy_touched_update=steps,
                node_dropout=4 * steps)
        if not (np.isfinite(result["value"]) and result["value"] > 0):
            raise AssertionError(f"phase 16 (e) bench: {result}")
        if detail["chain"] != MESH_CHAIN or detail["mesh"] != (None if mesh_shape is None else "1x1"):
            raise AssertionError(f"phase 16 (e) bench did not run the path asked for: {detail}")
        results.append(result)
        torch.cuda.empty_cache()
    return results, launches


def host_split(detail: dict) -> dict:
    """The bench's timed windows' host seconds an epoch, by what the host
    did (``bench.HostAccount``): waiting on the prefetch thread, chained
    dispatches, single steps, the fence, and collections inside them."""
    windows = [detail["host"][w] for w in ("short", "long")]
    epochs = sum(len(w["epoch_host_s"]) for w in windows)
    return {k: sum(w[f"{k}_s"] for w in windows) / epochs for k in ("wait", "chained", "single", "fence", "gc")}


def mesh_phase(gen: torch.Generator, epoch: list) -> tuple[dict, dict]:
    """Phase 16: (a) B1 at full width, (b) the 1x1 NCCL mesh's Trainers
    against one GPU's, (c) the bench over the mesh against without it, (d)
    the chained mesh Trainers against the unchained ones and one GPU's, (e)
    the chained bench over the mesh against without it. Returns the results
    and the mesh path's launches ((b)'s and (d)'s mesh runs, (c)'s and (e)'s
    first mesh bench)."""
    t0 = time.perf_counter()
    out = {"b1": {}}
    for label, dtype, stochastic in (("f32", torch.float32, False), ("bf16+sr", torch.bfloat16, True)):
        out["b1"][label] = check_sharded_sparse_adamw(gen, dtype, stochastic)
        for row in out["b1"][label]:
            log(f"[phase 16] (a) sharded_sparse_adamw {json.dumps(row)}")
        torch.cuda.empty_cache()
    mesh = join_nccl_group_of_one()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            out["trainer"], launches = mesh_against_one_gpu(mesh, epoch, Path(tmp))
        log(f"[phase 16] (b) 1x1 NCCL mesh against one GPU {json.dumps(out['trainer'])}")
        out["bench"], bench_launches = bench_over_the_mesh()
        chain_epoch, chain_val, counts = mesh_chain_epoch()
        with tempfile.TemporaryDirectory() as tmp:
            out["chained"], chained_launches = chained_mesh_against_unchained(mesh, chain_epoch, chain_val, counts,
                                                                               Path(tmp))
        del chain_epoch, chain_val
        log(f"[phase 16] (d) chained 1x1 NCCL mesh against unchained and one GPU {json.dumps(out['chained'])}")
        out["bench_chained"], bench_chained_launches = bench_chained_over_the_mesh()
    finally:
        distributed.shutdown()
    launches = {k: launches[k] + bench_launches[k] + chained_launches[k] + bench_chained_launches[k]
                for k in launches}
    for part, key in (("(c)", "bench"), ("(e)", "bench_chained")):
        for result in out[key]:
            log(f"[phase 16] {part} bench {json.dumps({k: v for k, v in result.items() if k != '_detail'})} "
                f"detail {json.dumps(result['_detail'])}")
            log(f"[phase 16] {part} mesh {result['_detail']['mesh']}: host seconds a timed epoch "
                f"{json.dumps(host_split(result['_detail']))}")
    log(f"[phase 16] launches on the mesh path {json.dumps(launches)}")
    out["seconds"] = time.perf_counter() - t0
    log(f"[phase 16] took {out['seconds']:.1f} s")
    return out, launches


# ---------------------------------------------------------------------------
# Phase 17: the Quickstart's export step and a server on what it writes, the
# tracked experiment runs, and the first optimizer of a process freed
# ---------------------------------------------------------------------------

# The JAX script's metadata keys, in its order, by mode.
EXPORT_KEYS = {
    "demo": ["mode", "exported_at", "num_items", "embedding_dim", "scorer_validation_max_diff",
             "scoring_latency_ms", "onnx_exported"],
    "production": ["mode", "exported_at", "source", "model_name", "epoch", "best_val_metric", "num_items",
                   "embedding_dim", "scorer_validation_max_diff", "scoring_latency_ms", "onnx_exported"],
}
EXPORT_VALIDATION_LIMIT = 1e-4  # export_onnx's own limit, the JAX script's
MLFLOW_EPOCHS, MLFLOW_BATCHES, MLFLOW_BATCH = 2, 4, 16  # the script's defaults and its batches
# Per dense step of each model (the smoke entry's): node-dropout launches, and
# kernel 1's layers (one forward and one backward launch each).
MLFLOW_PER_STEP = {"graphsage": (6, 0), "gat": (10, 0), "graph_transformer": (18, 3),
                   "graph_transformer_optimized": (4, 2)}
# Each epoch's mean train loss, the card against the script's CPU run from the
# same weights (the same dropout bits, float32, summation orders differ),
# relative: 15x the largest difference measured on an H100, 6.4e-7
# (graph_transformer; the other three 1.5e-7 to 2.7e-7).
MLFLOW_LOSS_RTOL = 1e-5

# A child process: the first optimizer of the process is built inside a
# function (a full-width lazy Trainer's) and dropped with the collector off;
# the card's memory must return to where it stood. Then a second build.
REPAIR_CHILD = r"""
import gc, json, sys, weakref
gc.disable()
import torch
from gat_recommendation_torch.models.registry import create_model
from gat_recommendation_torch.train.optimizers import FusedEmbeddingAdamW
from gat_recommendation_torch.train.trainer import Trainer


def build():
    model = create_model("graph_transformer_optimized", int(sys.argv[1]), device="cuda")
    trainer = Trainer(model, lambda epoch: [], lambda: [], optimizer=FusedEmbeddingAdamW(1e-3, weight_decay=1e-5,
                      lazy=True), output_dir=sys.argv[2], sparse_embedding_grads=True, chain=32, device="cuda")
    trainer.init_state()
    torch.cuda.synchronize()
    return weakref.ref(trainer), torch.cuda.memory_allocated()


out = []
for _ in range(2):
    before = torch.cuda.memory_allocated()
    trainer, built = build()
    out.append({"before": before, "built": built, "after": torch.cuda.memory_allocated(),
                "trainer_alive": trainer() is not None})
print(json.dumps({"builds": out, "gc_enabled": gc.isenabled()}))
"""


def start_repair_child(workdir: Path) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", REPAIR_CHILD, str(NUM_ITEMS), str(workdir / "repair")],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO)


def repair_result(child: subprocess.Popen) -> dict:
    """The child's builds: the first Trainer freed at once (its weak
    reference dead, memory_allocated back to its level before the build)."""
    stdout, stderr = child.communicate(timeout=600)
    if child.returncode != 0:
        raise AssertionError(f"the repair child failed: rc {child.returncode}\n{stderr[-3000:]}")
    got = json.loads(stdout.splitlines()[-1])
    for i, b in enumerate(got["builds"]):
        if b["trainer_alive"] or b["after"] != b["before"] or got["gc_enabled"]:
            raise AssertionError(f"build {i + 1} of a full-width Trainer was not freed when dropped: {got}")
    first = got["builds"][0]
    return {**got, "mb_freed": (first["built"] - first["after"]) / 2 ** 20}


def export_production(ckpt: Path, out: Path) -> dict:
    """export_onnx --mode production on `ckpt`: item_embeddings.npy EQUAL
    (bytes) to the table restore_params_state gives, in its padded shape;
    the metadata with the JAX script's keys; the scorer check under its
    limit. Seconds of the whole export."""
    t0 = time.perf_counter()
    meta = export_onnx.main(["--mode", "production", "--checkpoint", str(ckpt), "--output-dir", str(out)])
    seconds = time.perf_counter() - t0
    cmeta = checkpoint.load_meta(ckpt)
    cfg = dict(cmeta["model_config"])
    catalog = cfg.pop("num_items")
    model = create_model(cmeta["model_name"], catalog, device="meta", **cfg)
    table = checkpoint.restore_params_state(ckpt, model, "cpu").item_embedding.detach().numpy()
    exported = np.load(out / "item_embeddings.npy")
    if exported.dtype != np.float32 or exported.shape != (padded_rows(catalog), cfg["embedding_dim"]) or \
            exported.tobytes() != table.tobytes():
        raise AssertionError(f"export of {ckpt}: {exported.dtype} {exported.shape} is not the checkpoint's table")
    if json.loads((out / "model_metadata.json").read_text()) != meta or list(meta) != EXPORT_KEYS["production"] \
            or meta["num_items"] != exported.shape[0] or meta["source"] != str(ckpt):
        raise AssertionError(f"export of {ckpt}: metadata {meta}")
    if not 0.0 <= meta["scorer_validation_max_diff"] <= EXPORT_VALIDATION_LIMIT:
        raise AssertionError(f"export of {ckpt}: scorer check {meta['scorer_validation_max_diff']}")
    return {"seconds": seconds, "rows": exported.shape[0], "catalog": catalog,
            "phantom_rows": exported.shape[0] - catalog, "mb": exported.nbytes / 1e6,
            **{k: meta[k] for k in ("model_name", "epoch", "best_val_metric", "scorer_validation_max_diff",
                                    "scoring_latency_ms", "onnx_exported")}}


def export_demo(out: Path) -> dict:
    """export_onnx --mode demo at the full catalog: the table default_rng(42) draws."""
    t0 = time.perf_counter()
    meta = export_onnx.main(["--mode", "demo", "--num-items", str(NUM_ITEMS), "--output-dir", str(out)])
    seconds = time.perf_counter() - t0
    want = np.random.default_rng(42).standard_normal((NUM_ITEMS, DIM)).astype(np.float32)
    if np.load(out / "item_embeddings.npy").tobytes() != want.tobytes() or list(meta) != EXPORT_KEYS["demo"] or \
            meta["scorer_validation_max_diff"] > EXPORT_VALIDATION_LIMIT:
        raise AssertionError(f"demo export: the table or the metadata differ: {meta}")
    return {"seconds": seconds, "rows": NUM_ITEMS, "mb": want.nbytes / 1e6,
            **{k: meta[k] for k in ("scorer_validation_max_diff", "scoring_latency_ms")}}


def vertex_on_export(export_dir: Path) -> dev_app.MeanEmbeddingModel:
    """The Vertex-style server's model as it starts with MODEL_DIR=export_dir
    (INFERENCE_MODE=embeddings: item_embeddings.npy), its table on the card
    EQUAL to the file's (not the demo table it would fall back to)."""
    saved = vertex_app.MODEL_DIR, vertex_app.INFERENCE_MODE
    vertex_app.MODEL_DIR, vertex_app.INFERENCE_MODE = export_dir, "embeddings"
    try:
        model = vertex_app.load_model("cuda")
    finally:
        vertex_app.MODEL_DIR, vertex_app.INFERENCE_MODE = saved
    if not torch.equal(model.item_embeddings.cpu(), torch.from_numpy(np.load(export_dir / "item_embeddings.npy"))):
        raise AssertionError(f"the Vertex server did not load {export_dir}/item_embeddings.npy")
    return model


def predictions(model: dev_app.MeanEmbeddingModel, instances: list[dict]) -> tuple[list, float, dict]:
    """POST /predict of the Vertex-style server on `model` over HTTP: each
    instance's (ids, scores), the call's ms and GET /health."""
    with serving(vertex_app.make_server(model, "127.0.0.1", 0)) as url:
        status, body, _ = get(f"{url}/health")
        health = json.loads(body)
        status_p, payload, ms = post(f"{url}/predict", {"instances": instances})
    if status != 200 or status_p != 200 or len(payload["predictions"]) != len(instances):
        raise AssertionError(f"vertex /predict: {status} {status_p} {str(payload)[:300]}")
    return [(p["recommendations"], p["scores"]) for p in payload["predictions"]], ms, health


def export_and_serve(quick_ckpt: Path, vertex_answers: list, workdir: Path) -> dict:
    """(a) the export of phase 13 (b)'s checkpoint_best, timed, and a demo
    export at the full catalog; (b) the Vertex-style server with MODEL_DIR
    on the export answers phase 14's requests through /predict as the server
    built from the checkpoint (phase 14's construction) does, EQUAL; and on
    the export of phase 4's checkpoint (written again from the same seeds)
    as phase 14's own server answered, EQUAL."""
    out: dict = {}
    out["export"] = export_production(quick_ckpt, workdir / "quickstart_export")
    log(f"[phase 17] export_onnx --mode production {json.dumps(out['export'])}")
    out["export_demo"] = export_demo(workdir / "demo_export")
    shutil.rmtree(workdir / "demo_export")
    log(f"[phase 17] export_onnx --mode demo --num-items {NUM_ITEMS} {json.dumps(out['export_demo'])}")

    instances = [{"session_items": r.session_items, "k": r.k}
                 for r in latency_bench.make_requests(NUM_ITEMS, SERVER_REQUESTS)]
    served = vertex_on_export(workdir / "quickstart_export")
    got, ms, health = predictions(served, instances)
    want, _, _ = predictions(dev_app.MeanEmbeddingModel.from_checkpoint(str(quick_ckpt), device="cuda"), instances)
    if got != want:
        raise AssertionError("the Vertex server on the export answers otherwise than on the checkpoint")
    catalog = out["export"]["catalog"]
    phantom_only, _, _ = predictions(served, [{"session_items": [catalog + 1], "k": 5}])
    out["served_export"] = {"instances": len(instances), "equal_to_checkpoint_server": True, "predict_ms": ms,
                            "health": health,
                            "phantom_ids_answered": sum(i >= catalog for ids, _ in got for i in ids),
                            "phantom_only_session": phantom_only[0]}
    log(f"[phase 17] Vertex server on MODEL_DIR={workdir / 'quickstart_export'} {json.dumps(out['served_export'])}")
    del served
    torch.cuda.empty_cache()

    make_checkpoint(workdir / "ckpt")
    out["export_phase4"] = export_production(workdir / "ckpt", workdir / "phase4_export")
    got4, ms4, _ = predictions(vertex_on_export(workdir / "phase4_export"), instances)
    if got4 != vertex_answers:
        raise AssertionError("the Vertex server on phase 4's export answers otherwise than phase 14's server")
    out["served_phase4_export"] = {"instances": len(instances), "equal_to_phase_14": True, "predict_ms": ms4}
    log(f"[phase 17] phase 4's checkpoint exported and served: {json.dumps(out['export_phase4'])} "
        f"{json.dumps(out['served_phase4_export'])}")
    torch.cuda.empty_cache()
    return out


def tracked_runs(workdir: Path) -> tuple[dict, dict]:
    """(c) mlflow_experiment for each model on the card, counted (per dense
    step 1 dense AdamW, and node dropout and kernel 1 as the model's layers
    take them), then the same script on the CPU: the run.json params equal,
    the losses finite and within MLFLOW_LOSS_RTOL: both runs draw their
    weights from the same default seed of a CPU generator, so they start
    from the same weights, and the dropout bits are the same on both."""
    card_dir, cpu_dir = workdir / "mlruns_card", workdir / "mlruns_cpu"
    steps = MLFLOW_EPOCHS * MLFLOW_BATCHES
    launches, seconds = {}, {}
    if list(MLFLOW_PER_STEP) != list(mlflow_experiment.MODEL_REGISTRY):
        raise AssertionError("MLFLOW_PER_STEP does not name the script's models")
    for name, (dropouts, layers) in MLFLOW_PER_STEP.items():
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        mlflow_experiment.main(["--models", name, "--epochs", str(MLFLOW_EPOCHS), "--tracking-dir", str(card_dir)])
        seconds[name] = time.perf_counter() - t0
        launches[name] = expect_counts(f"mlflow_experiment {name}", embedding_adamw=steps,
                                       node_dropout=dropouts * steps, session_attention=layers * steps,
                                       session_attention_backward=layers * steps)
    t0 = time.perf_counter()
    mlflow_experiment.main(["--epochs", str(MLFLOW_EPOCHS), "--tracking-dir", str(cpu_dir), "--device", "cpu"])
    cpu_seconds = time.perf_counter() - t0

    def run_of(root: Path, name: str) -> dict:
        (path,) = (root / "session-recommendation").glob(f"{name}-*/run.json")
        return json.loads(path.read_text())

    runs = {}
    for name in MLFLOW_PER_STEP:
        card, cpu = run_of(card_dir, name), run_of(cpu_dir, name)
        got, want = ([m["value"] for m in r["metrics"]["train_loss"]] for r in (card, cpu))
        if card["params"] != cpu["params"] or len(got) != MLFLOW_EPOCHS or not np.all(np.isfinite(got)):
            raise AssertionError(f"mlflow_experiment {name}: card {card['params']} {got}, cpu {cpu['params']} {want}")
        runs[name] = {"num_params": int(card["params"]["num_params"]), "card_train_loss": got,
                      "cpu_train_loss": want,
                      "max_rel_diff": max(abs(a - b) / abs(b) for a, b in zip(got, want)),
                      "card_s": seconds[name]}
    off = {name: r["max_rel_diff"] for name, r in runs.items() if r["max_rel_diff"] > MLFLOW_LOSS_RTOL}
    if off:
        raise AssertionError(f"mlflow_experiment: card losses off the CPU run's beyond {MLFLOW_LOSS_RTOL}: {off}")
    total = {k: sum(c[k] for c in launches.values()) for k in launch_counts()}
    return {"runs": runs, "cpu_s": cpu_seconds, "launches_by_model": launches}, total


def export_serve_track(gen: torch.Generator, quick_ckpt: Path, vertex_answers: list) -> tuple[dict, dict]:
    """Phase 17: (a) and (b) export_and_serve, (c) tracked_runs with the
    kernels checked at that path's shapes (B = 16, N = 8, widths 32), (d) the
    repair child beside (c)."""
    out: dict = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        workdir = Path(tmp)
        out.update(export_and_serve(quick_ckpt, vertex_answers, workdir))
        child = start_repair_child(workdir)  # its start-up beside (c), which times nothing that matters here
        out["tracked"], launches = tracked_runs(workdir)
        log(f"[phase 17] mlflow_experiment, card against CPU {json.dumps(out['tracked'])}")
        out["repair"] = repair_result(child)
        log(f"[phase 17] the first Trainer of a process, dropped with gc off: {json.dumps(out['repair'])}")
    out["attention"] = [check_attention_training(MLFLOW_BATCH, SMOKE_NODES, DROPOUT, gen, heads=h, dim=SMOKE_DIM,
                                                 packed=True) for h in SMOKE_HEADS]
    out["dropout"] = [check_node_dropout(gen, (MLFLOW_BATCH, *shape[1:])) for shape in SMOKE_DROPOUT_SHAPES]
    for name, row in (*((f"session_attention {part}", r) for a in out["attention"] for part, r in a.items()),
                      *(("node_dropout", r) for r in out["dropout"])):
        log(f"[phase 17] mlflow_experiment shapes: {name} {json.dumps(row)}")
    log(f"[phase 17] launches on the mlflow_experiment path {json.dumps(launches)}")
    out["seconds"] = time.perf_counter() - t0
    log(f"[phase 17] took {out['seconds']:.1f} s")
    return out, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1

    phase("1")
    smi = nvidia_smi()
    log(f"[phase 1] {smi}")
    log(f"[phase 1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[phase 1] TF32 set off for matmul and cuDNN: every float32 product is full float32")

    phase("2")
    seconds = _build.build()
    log(f"[phase 2] kernels built in {seconds:.1f} s")
    for name in _build.KERNELS:
        log_path = _build.library_path(name).with_suffix(".so.log")
        for line in log_path.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[phase 2] {name}: {line.strip()}")
    series_sass = lazy_series_sass(_build.library_path("lazy_adamw"))
    log(f"[phase 2] lazy series loops in SASS: {json.dumps(series_sass)}")
    for name, counts in series_sass.items():
        if counts["fchk"]:
            raise AssertionError(f"{name}: the series loop still holds the IEEE division's check (FCHK): {counts}")

    phase("3")
    gen = torch.Generator(device="cuda").manual_seed(0)
    attn = {(B, N): check_attention(B, N, gen) for B, N in [(1, n) for n in BUCKETS] + [(512, 56)]}
    for row in attn.values():
        log(f"[phase 3] session_attention {json.dumps(row)}")
    score = check_scoring(gen)
    log(f"[phase 3] score_chunkmax {json.dumps(score)}")
    for B in (1, 130):
        check_ties(gen, B)
    log("[phase 3] integer-valued tie case at B=1 and B=130: kernel top-k equals the stable dense top-k")
    attention_crossover = crossover_attention(gen)
    for row in attention_crossover:
        log(f"[phase 3] session_attention warp vs staged {json.dumps(row)}")
    check_crossover(attention_crossover, "session_attention")
    scoring_crossover = crossover_scoring(gen)
    for row in scoring_crossover:
        log(f"[phase 3] score_chunkmax warp vs tile {json.dumps(row)}")
    check_crossover(scoring_crossover, "score_chunkmax")
    torch.cuda.empty_cache()

    phase("4")
    with tempfile.TemporaryDirectory() as tmp:
        served = serve_full_width(Path(tmp))
        latency, latency_launches = serving_latency(Path(tmp))
    profiled = served.pop("profile")
    log(f"[phase 4] {json.dumps(served)}")

    phase("5")
    n = served["requests"]
    launches = served["launches"]
    if launches["session_attention"] != 2 * n or launches["score_chunkmax"] != n:
        raise AssertionError(f"launch counts {launches} over {n} requests, want 2 and 1 per request")
    if launches["session_attention_staged"] or launches["score_chunkmax_tile"]:
        raise AssertionError(f"a single request must not take the batch kernels: {launches}")
    if launches["session_attention_packed"]:
        raise AssertionError(f"serving builds a bool adjacency; no launch may read packed rows: {launches}")
    log(f"[phase 5] launches over {n} requests: {json.dumps(launches)}")

    phase("6")
    log(f"[phase 6] {json.dumps(profiled)}")

    phase("7")
    gen = torch.Generator(device="cuda").manual_seed(1)
    train_attn = {}
    for N in BUCKETS:
        for p_drop in (0.0, DROPOUT) if N in (8, 56) else (DROPOUT,):
            train_attn[(N, p_drop)] = check_attention_training(TRAIN_BATCH, N, p_drop, gen, packed=True)
            for part, row in train_attn[(N, p_drop)].items():
                log(f"[phase 7] session_attention {part} {json.dumps(row)}")
    adamw = {}
    for label, dtype, stochastic in (("f32", torch.float32, False), ("bf16+sr", torch.bfloat16, True)):
        adamw[("sparse_adamw", label)] = check_sparse_adamw(gen, dtype, stochastic)
        log(f"[phase 7] sparse_adamw {json.dumps(adamw[('sparse_adamw', label)])}")
        adamw[("embedding_adamw", label)] = check_embedding_adamw(gen, dtype, stochastic)
        log(f"[phase 7] embedding_adamw {json.dumps(adamw[('embedding_adamw', label)])}")
        torch.cuda.empty_cache()
    score_eval = check_scoring(gen, B=TRAIN_BATCH)
    log(f"[phase 7] score_chunkmax {json.dumps(score_eval)}")
    dropout_row = check_node_dropout(gen)
    log(f"[phase 7] node_dropout {json.dumps(dropout_row)}")
    torch.cuda.empty_cache()
    lazy_rows = {}
    for label, dtype, stochastic in (("f32", torch.float32, False), ("bf16+sr", torch.bfloat16, True)):
        for name, row in check_lazy_kernels(gen, dtype, stochastic, series_sass).items():
            lazy_rows[(name, label)] = row
            log(f"[phase 7] {name} {json.dumps(row)}")
        torch.cuda.empty_cache()

    phase("8")
    by_bucket, epoch = training_batches()
    trained = train_full_width(by_bucket, epoch)
    train_profile = trained.pop("profile")
    log(f"[phase 8] {json.dumps(trained)}")
    train_launches = trained["launches"]
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        lazy_trained = train_lazy_full_width(by_bucket, epoch, Path(tmp))
    log(f"[phase 8] lazy {json.dumps(lazy_trained)}")
    lazy_launches = lazy_trained["launches"]
    torch.cuda.empty_cache()
    chain_dataset, chain_epoch, chain_val = chained_corpus()
    with tempfile.TemporaryDirectory() as tmp:
        chained_trained, chained_run = train_chained_full_width(chain_epoch, chain_val, Path(tmp))
    log(f"[phase 8] chained {json.dumps(chained_trained)}")
    torch.cuda.empty_cache()
    replay = graph_steps_against_eager([by_bucket[56][0]], lazy=True, groups=[1, 1])
    log(f"[phase 8] a replayed lazy step against the eager one {json.dumps(replay)}")
    eager_group = graph_steps_against_eager(by_bucket[8], lazy=False, groups=[4, 4])
    log(f"[phase 8] eager sparse groups of 4 against eager steps {json.dumps(eager_group)}")
    chained_launches = {**chained_trained["launches"], "sparse_adamw": eager_group["launches"]["sparse_adamw"]}

    phase("9")
    log(f"[phase 9] {json.dumps(train_profile)}")
    log(f"[phase 9] lazy {json.dumps(profile_lazy(create_loss_function('dual'), by_bucket))}")
    torch.cuda.empty_cache()
    log(f"[phase 9] chain {json.dumps(chain_timing(chain_epoch))}")

    phase("10")
    log(f"[phase 10] batch engines {json.dumps(batch_engines())}")

    phase("11")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        piped = pipelined_against_inline(chain_dataset, chain_val, chained_run, Path(tmp))
    del chained_run
    log(f"[phase 11] pipelined against inline train() {json.dumps(piped)}")
    torch.cuda.empty_cache()
    bench_results, bench_launches = bench_runs()
    for result in bench_results:
        detail = result.pop("_detail")
        log(f"[phase 11] bench {json.dumps(result)}")
        log(f"[phase 11] bench detail {json.dumps(detail)}")
    log(f"[phase 11] latency bench {json.dumps(latency)}")
    log(f"[phase 11] launches: bench {json.dumps(bench_launches)}, latency bench {json.dumps(latency_launches)}")

    # Phase 12: the rest of the model zoo
    phase("12")
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(3)
    attn_h4 = {N: check_attention_training(TRAIN_BATCH, N, DROPOUT, gen, heads=ZOO_HEADS, packed=True)
               for N in (8, 56)}
    for row in attn_h4.values():
        for part, r in row.items():
            log(f"[phase 12] session_attention {part} {json.dumps(r)}")
    zoo_dropout = {label: check_node_dropout(gen, shape) for label, shape in ZOO_DROPOUT_SHAPES.items()}
    for label, row in zoo_dropout.items():
        log(f"[phase 12] node_dropout {label} {json.dumps(row)}")
    torch.cuda.empty_cache()
    smoke_attn = [check_attention_training(SMOKE_BATCH, SMOKE_NODES, DROPOUT, gen, heads=h, dim=SMOKE_DIM,
                                           packed=True)
                  for h in SMOKE_HEADS]
    smoke_dropout = [check_node_dropout(gen, shape) for shape in SMOKE_DROPOUT_SHAPES]
    smoke_adamw = check_embedding_adamw(gen, torch.float32, False, rows=SMOKE_ROWS, dim=SMOKE_DIM)
    for name, row in (*((f"session_attention {part}", r) for a in smoke_attn for part, r in a.items()),
                      *(("node_dropout", r) for r in smoke_dropout), ("embedding_adamw", smoke_adamw)):
        log(f"[phase 12] smoke shapes: {name} {json.dumps(row)}")
    with tempfile.TemporaryDirectory() as tmp:
        log(f"[phase 12] seeded weights, card against CPU {json.dumps(seeded_weights_on_card_and_cpu(Path(tmp)))}")
    zoo, zoo_serving = {}, {}
    for label, name, fields, node_dropouts, attention in ZOO:  # each model's checkpoints go with its directory
        with tempfile.TemporaryDirectory() as tmp:
            zoo[label] = train_zoo_model(label, name, fields, node_dropouts, attention, by_bucket, epoch, Path(tmp))
        log(f"[phase 12] {label} {json.dumps(zoo[label])}")
    for name, fields in (("gat", {}), ("graphsage", {"aggregator": "mean"})):
        with tempfile.TemporaryDirectory() as tmp:
            zoo_serving[name] = serve_zoo_model(name, fields, Path(tmp))
        log(f"[phase 12] serving {json.dumps(zoo_serving[name])}")
    child = start_smoke_child()  # beside the checks below, which time nothing on the card
    for name in ("gat", "graph_transformer"):
        with tempfile.TemporaryDirectory() as tmp:
            log(f"[phase 12] chained {json.dumps(zoo_chained_against_unchained(name, {}, chain_epoch, Path(tmp)))}")
    with tempfile.TemporaryDirectory() as tmp:
        log(f"[phase 12] PE {json.dumps(pe_on_the_bench_graph(Path(tmp)))}")
    smoke = smoke_entry(child)
    log(f"[phase 12] smoke_test_all_models {json.dumps(smoke)}")
    zoo_launches = {f"zoo_{label}": r["launches"] for label, r in zoo.items()}
    zoo_launches.update({f"zoo_serving_{name}": r["launches"] for name, r in zoo_serving.items()})
    zoo_launches["zoo_smoke"] = smoke["launches"]

    # Phase 13: the Quickstart on the card, in a directory that phase 15 reads too
    phase("13")
    torch.cuda.empty_cache()
    quick_dir = tempfile.TemporaryDirectory()
    quick = quickstart(torch.Generator(device="cuda").manual_seed(13), series_sass, Path(quick_dir.name))
    qk = quick["kernels"]
    quick_launches = {
        "quickstart_train": quick["train"]["launches"],
        "quickstart_lazy": quick["lazy"]["launches"],
        "quickstart_eval": {k: quick["eval_eager"]["launches"][k] + quick["eval_lazy"]["launches"][k]
                            for k in quick["eval_eager"]["launches"]},
        "quickstart_gate": quick["gate"]["launches"],
        "quickstart_pipeline": quick["pipeline"]["launches"],
    }

    # Phase 14: what serving still lacked
    phase("14")
    torch.cuda.empty_cache()
    rest, rest_launches = serving_rest(torch.Generator(device="cuda").manual_seed(14))

    # Phase 15: the study and tool scripts, and the packed adjacency
    phase("15")
    torch.cuda.empty_cache()
    counted = {"serving": launches, "training": train_launches, "training_lazy": lazy_launches,
               "training_chained": chained_launches, "bench_e2e": bench_launches, "latency_bench": latency_launches,
               "serving_int8": rest_launches["serving_int8"], "quickstart_train": quick_launches["quickstart_train"],
               "quickstart_lazy": quick_launches["quickstart_lazy"],
               "quickstart_eval": quick_launches["quickstart_eval"],
               "quickstart_pipeline": quick_launches["quickstart_pipeline"], **zoo_launches}
    study, study_launches = studies_and_packing(torch.Generator(device="cuda").manual_seed(15),
                                                Path(quick_dir.name) / "data" / "processed", bench_results,
                                                counted)

    # Phase 16: the mesh (B1 at full width, the 1x1 NCCL mesh's Trainers, the bench over it)
    phase("16")
    torch.cuda.empty_cache()
    meshed, mesh_launches = mesh_phase(torch.Generator(device="cuda").manual_seed(16), epoch)
    b1_main = with_shapes(meshed["b1"]["f32"][0], *meshed["b1"]["f32"][1:], *meshed["b1"]["bf16+sr"])

    # Phase 17: the Quickstart's export step and its server, the tracked runs, the repair
    phase("17")
    torch.cuda.empty_cache()
    tracked, tracked_launches = export_serve_track(torch.Generator(device="cuda").manual_seed(17),
                                                   Path(quick_dir.name) / EXPORTED_CHECKPOINT,
                                                   rest["vertex_answers"])
    quick_dir.cleanup()

    # Phase 18: one row per kernel and path, every key in every row.
    phase("18")
    kernels = []
    for name, path, row, count in (
        ("session_attention", "serving", attn[(1, 56)], launches["session_attention"]),
        ("score_chunkmax", "serving", score, launches["score_chunkmax"]),
        ("session_attention", "training", train_attn[(56, DROPOUT)]["forward"],
         train_launches["session_attention"]),
        ("session_attention_backward", "training", train_attn[(56, DROPOUT)]["backward"],
         train_launches["session_attention_backward"]),
        ("score_chunkmax", "training", score_eval, train_launches["score_chunkmax"]),
        ("sparse_adamw", "training", adamw[("sparse_adamw", "f32")], train_launches["sparse_adamw"]),
        ("embedding_adamw", "training", adamw[("embedding_adamw", "f32")],
         train_launches["embedding_adamw"]),
        *((name, "training_lazy", lazy_rows[(name, "f32")], lazy_launches[name])
          for name in ("lazy_gather_catch_up", "lazy_touched_update", "lazy_materialize")),
        ("node_dropout", "training", dropout_row, train_launches["node_dropout"]),
        ("node_dropout", "training_lazy", dropout_row, lazy_launches["node_dropout"]),
        # The chained path: the same kernels inside the CUDA graphs (materialize outside).
        ("session_attention", "training_chained", train_attn[(56, DROPOUT)]["forward"],
         chained_launches["session_attention"]),
        ("session_attention_backward", "training_chained", train_attn[(56, DROPOUT)]["backward"],
         chained_launches["session_attention_backward"]),
        ("score_chunkmax", "training_chained", score_eval, chained_launches["score_chunkmax"]),
        ("sparse_adamw", "training_chained", adamw[("sparse_adamw", "f32")], chained_launches["sparse_adamw"]),
        *((name, "training_chained", lazy_rows[(name, "f32")], chained_launches[name])
          for name in ("lazy_gather_catch_up", "lazy_touched_update", "lazy_materialize")),
        ("node_dropout", "training_chained", dropout_row, chained_launches["node_dropout"]),
        # The host pipeline's paths: the bench's epochs (chain 32) and the latency bench.
        ("session_attention", "bench_e2e", train_attn[(56, DROPOUT)]["forward"], bench_launches["session_attention"]),
        ("session_attention_backward", "bench_e2e", train_attn[(56, DROPOUT)]["backward"],
         bench_launches["session_attention_backward"]),
        *((name, "bench_e2e", lazy_rows[(name, "f32")], bench_launches[name])
          for name in ("lazy_gather_catch_up", "lazy_touched_update")),
        ("node_dropout", "bench_e2e", dropout_row, bench_launches["node_dropout"]),
        ("session_attention", "latency_bench", attn[(1, 56)], latency_launches["session_attention"]),
        ("score_chunkmax", "latency_bench", score, latency_launches["score_chunkmax"]),
        # The model zoo: each model's lazy Trainer.train(), serving, the smoke entry's dense steps.
        ("session_attention", "zoo_graph_transformer", attn_h4[56]["forward"],
         zoo_launches["zoo_graph_transformer"]["session_attention"]),
        ("session_attention_backward", "zoo_graph_transformer", attn_h4[56]["backward"],
         zoo_launches["zoo_graph_transformer"]["session_attention_backward"]),
        *((name, f"zoo_{label}", row, zoo_launches[f"zoo_{label}"][name])
          for label, *_ in ZOO
          for name, row in (("score_chunkmax", score_eval),
                            ("node_dropout", with_shapes(zoo_dropout[label], dropout_row)
                             if label in zoo_dropout else dropout_row),
                            *((k, lazy_rows[(k, "f32")]) for k in
                              ("lazy_gather_catch_up", "lazy_touched_update", "lazy_materialize")))),
        *(("score_chunkmax", f"zoo_serving_{name}", score, zoo_launches[f"zoo_serving_{name}"]["score_chunkmax"])
          for name in zoo_serving),
        # The smoke entry's dense steps, at its own shapes.
        ("embedding_adamw", "zoo_smoke", smoke_adamw, zoo_launches["zoo_smoke"]["embedding_adamw"]),
        ("node_dropout", "zoo_smoke", with_shapes(*smoke_dropout), zoo_launches["zoo_smoke"]["node_dropout"]),
        *((part, "zoo_smoke", with_shapes(*(a[key] for a in smoke_attn)), zoo_launches["zoo_smoke"][part])
          for part, key in (("session_attention", "forward"), ("session_attention_backward", "backward"))),
        # The Quickstart (phase 13), each path at its own shapes (phase 13 (f)):
        # train_baseline's defaults (B = 128, eager sparse), its --lazy-adamw run
        # (B = 512), evaluate_local (B = 256), the gate (B = 256 and its latency
        # requests at B = 1), run_full_pipeline (B = 32, D = 64); the main shape
        # at the node bucket with the most sessions.
        *((name, path, row, quick_launches[path][name]) for name, path, row in (
            *((part, f"quickstart_{label}", with_shapes(*(a[key] for a in qk[f"{label}_attention"])))
              for label in ("train", "lazy", "pipeline")
              for part, key in (("session_attention", "forward"), ("session_attention_backward", "backward"))),
            ("sparse_adamw", "quickstart_train", with_shapes(*qk["train_sparse_adamw"])),
            *(("node_dropout", f"quickstart_{label}", with_shapes(*qk[f"{label}_dropout"]))
              for label in ("train", "lazy", "pipeline")),
            # materialize's work is the whole table's, whatever the batch: one shape
            *((k, "quickstart_lazy", with_shapes(*(rows[k] for rows in qk["lazy_adamw"][:1 if last else None])))
              for k, last in (("lazy_gather_catch_up", False), ("lazy_touched_update", False),
                              ("lazy_materialize", True))),
            *(("score_chunkmax", f"quickstart_{label}", with_shapes(qk[f"{label}_score"]))
              for label in ("train", "lazy", "eval", "pipeline")),
            ("session_attention", "quickstart_eval", with_shapes(*qk["eval_attention"])),
            ("session_attention", "quickstart_gate", with_shapes(*qk["eval_attention"], *qk["gate_attention"])),
            ("score_chunkmax", "quickstart_gate", with_shapes(qk["eval_score"], qk["gate_score"])),
            ("embedding_adamw", "quickstart_pipeline", with_shapes(qk["pipeline_adamw"])),
        )),
        # Phase 14: the int8 path's forward (kernel 1), approx and two-level at
        # chunk 32 (kernel 2 at B = 1 with the serving mask and at B = 512),
        # the scoring bench (B = 512).
        ("session_attention", "serving_int8", attn[(1, 56)], rest_launches["serving_int8"]["session_attention"]),
        ("score_chunkmax", "approx", with_shapes(score, score_eval), rest_launches["approx"]["score_chunkmax"]),
        ("score_chunkmax", "two_level_chunk32", with_shapes(score, score_eval),
         rest_launches["two_level_chunk32"]["score_chunkmax"]),
        ("score_chunkmax", "bench_scoring", score_eval, rest_launches["bench_scoring"]["score_chunkmax"]),
        # Phase 15: the study and tool scripts, kernel 1 reading the packed rows.
        ("sparse_adamw", "validate_sr_onchip", study["sr_adamw"], study_launches["validate_sr_onchip"]["sparse_adamw"]),
        ("session_attention", "bench_attention", with_shapes(*study["bench_attention_rows"][::-1]),
         study_launches["bench_attention"]["session_attention"]),
        *((part, "corpus_discrimination", with_shapes(*(a[key] for a in study["probe_attention"])),
           study_launches["corpus_discrimination"][part])
          for part, key in (("session_attention", "forward"), ("session_attention_backward", "backward"))),
        ("sparse_adamw", "corpus_discrimination", study["probe_adamw"],
         study_launches["corpus_discrimination"]["sparse_adamw"]),
        ("score_chunkmax", "corpus_discrimination", study["probe_score"],
         study_launches["corpus_discrimination"]["score_chunkmax"]),
        ("node_dropout", "corpus_discrimination", with_shapes(*qk["train_dropout"]),
         study_launches["corpus_discrimination"]["node_dropout"]),
        *((part, "run_ablations", with_shapes(*(a[key] for a in qk["train_attention"])),
           study_launches["run_ablations"][part])
          for part, key in (("session_attention", "forward"), ("session_attention_backward", "backward"))),
        ("embedding_adamw", "run_ablations", adamw[("embedding_adamw", "f32")],
         study_launches["run_ablations"]["embedding_adamw"]),
        ("score_chunkmax", "run_ablations", qk["train_score"], study_launches["run_ablations"]["score_chunkmax"]),
        ("node_dropout", "run_ablations", with_shapes(*qk["train_dropout"]),
         study_launches["run_ablations"]["node_dropout"]),
        # Phase 16: the 1x1 NCCL mesh's Trainers and bench; B1 at the whole table (n_model = 1),
        # its 2, 4 and 8 shards and bf16+SR moments among the shapes checked.
        ("sharded_sparse_adamw", "mesh", b1_main, mesh_launches["sharded_sparse_adamw"]),
        ("session_attention", "mesh", train_attn[(56, DROPOUT)]["forward"], mesh_launches["session_attention"]),
        ("session_attention_backward", "mesh", train_attn[(56, DROPOUT)]["backward"],
         mesh_launches["session_attention_backward"]),
        ("score_chunkmax", "mesh", score_eval, mesh_launches["score_chunkmax"]),
        ("embedding_adamw", "mesh", adamw[("embedding_adamw", "f32")], mesh_launches["embedding_adamw"]),
        *((name, "mesh", lazy_rows[(name, "f32")], mesh_launches[name])
          for name in ("lazy_gather_catch_up", "lazy_touched_update", "lazy_materialize")),
        ("node_dropout", "mesh", dropout_row, mesh_launches["node_dropout"]),
        # Phase 17: mlflow_experiment's dense steps over the four models (B = 16, N = 8,
        # widths 32; the table [512, 32] as the smoke entry's).
        ("embedding_adamw", "mlflow_experiment", smoke_adamw, tracked_launches["embedding_adamw"]),
        ("node_dropout", "mlflow_experiment", with_shapes(*tracked["dropout"]), tracked_launches["node_dropout"]),
        *((part, "mlflow_experiment", with_shapes(*(a[key] for a in tracked["attention"])), tracked_launches[part])
          for part, key in (("session_attention", "forward"), ("session_attention_backward", "backward"))),
    ):
        if count < 1:
            raise AssertionError(f"{name} was not launched on the {path} path")
        # Which of a wrapper's two kernels the path ran, by the second counters.
        batch = {"session_attention": "staged", "score_chunkmax": "tile"}.get(name)
        counts = {"serving": launches, "training": train_launches, "training_lazy": lazy_launches,
                  "training_chained": chained_launches, "bench_e2e": bench_launches,
                  "latency_bench": latency_launches, **zoo_launches, **quick_launches, **rest_launches,
                  **study_launches, "mesh": mesh_launches, "mlflow_experiment": tracked_launches}[path]
        n_batch = None if batch is None else counts[f"{name}_{batch}"]
        kernels.append({
            "name": name,
            "path": path,
            "variant": None if batch is None else batch if n_batch == count else "warp" if n_batch == 0 else "mixed",
            "route": "cuda",
            "source": SOURCES[name],
            "replaces": REPLACES[name],
            "shape": row["shape"],
            "launches": count,
            "max_abs_err": row["max_abs_err"],
            "max_err": row["max_abs_err"],
            "ms": row["ms"],
            "kernel_ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "launch_floor_ms": row.get("launch_floor_ms"),
            "shapes_checked": row.get("shapes_checked"),
        })
    print(json.dumps({"phase_seconds": phase_seconds(), "total_s": time.perf_counter() - _START}))
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
