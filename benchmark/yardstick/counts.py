"""Operation counts and the bound of a piece of work on the card.

``bound_s`` is the least time the card could take: the larger of the bytes
over the memory rate and the work over the peak rate of its kind. The model
counts are the matrix products that the batches need, two operations a
multiply-add, over the valid sessions' real nodes and edges only (the
padding that the program's buckets add is not work the inputs need).
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def bound_s(n_bytes: float = 0.0, n_flops: float = 0.0, n_instructions: float = 0.0,
            n_int_instructions: float = 0.0, n_mufu: float = 0.0) -> float:
    return max(n_bytes / PEAKS["hbm_bytes_per_s"], n_flops / PEAKS["fp32_flop_per_s"],
               n_instructions / PEAKS["fp32_instructions_per_s"],
               n_int_instructions / PEAKS["int32_instructions_per_s"], n_mufu / PEAKS["mufu_per_s"])


def heads_width(cfg: dict) -> int:
    return cfg["num_heads"] * (cfg["hidden_dim"] // cfg["num_heads"])


def forward_flops(cfg: dict, nodes: float, edges: float) -> float:
    """The forward's products over `nodes` real nodes and `edges` edges:
    the encodings' projection; per layer the query, key, value and skip
    linears, the gate, the attention (a score and a weighted value row per
    edge and head), and the FFN's two linears."""
    D, HD, L = cfg["embedding_dim"], heads_width(cfg), cfg["num_layers"]
    out = 2.0 * nodes * cfg["laplacian_k"] * D if cfg["use_laplacian_pe"] else 0.0
    for layer in range(L):
        d_in = D if layer == 0 else cfg["hidden_dim"]
        out += 4 * 2.0 * nodes * d_in * HD + 2.0 * nodes * 3 * HD + 4.0 * edges * HD
        if cfg["use_ffn"]:
            out += 2 * 2.0 * nodes * HD * cfg["ffn_expansion"] * cfg["hidden_dim"]
    return out


def train_flops(cfg: dict, sessions: float, nodes: float, edges: float) -> float:
    """Forward, the loss's 1 + K scores a session, and the backward (twice
    the forward): three times the forward's products."""
    loss = 2.0 * sessions * (1 + cfg["num_negatives"]) * cfg["hidden_dim"]
    return 3.0 * (forward_flops(cfg, nodes, edges) + loss)


def eval_flops(cfg: dict, sessions: float, nodes: float, edges: float) -> float:
    """The eval forward and the full-catalog scores (2 D V a session)."""
    return forward_flops(cfg, nodes, edges) + 2.0 * sessions * cfg["hidden_dim"] * cfg["num_items"]
