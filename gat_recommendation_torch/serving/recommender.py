"""Per-request recommender: the GNN forward plus a full-catalog top-k.

Loads a checkpoint of any model of the registry (``train/checkpoint.py``;
the optimized Graph Transformer is the one it is made for, GAT and GraphSAGE
load by their ``model_name``) and serves top-k by running the GNN forward on
the session's induced co-occurrence subgraph, then scoring the whole catalog
with the seen items, the padding row 0 and the phantom rows masked to -inf,
and selecting the exact top-k (``ops/scoring.full_catalog_topk``). On the
card the attention core of the Graph Transformer and the scoring pass are
the CUDA kernels of ``ops/``.

The semantics are those of the JAX package's exact path: FFN checkpoints
are rejected; the stored config is cross-checked against the table shape;
self-loops are dropped from the edges; sessions are padded to node-count
buckets. The JAX package's int8 candidate scorer for CPU hosts is not ported.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from gat_recommendation_torch.data.batching import (
    SessionBatch,
    build_csr,
    induced_edges,
    pick_bucket,
)
from gat_recommendation_torch.data.graph import load_edges
from gat_recommendation_torch.device import resolve_device
from gat_recommendation_torch.models.base import padded_rows
from gat_recommendation_torch.models.registry import create_model
from gat_recommendation_torch.ops.scoring import full_catalog_topk
from gat_recommendation_torch.serving.config import DEFAULT_LIMITS
from gat_recommendation_torch.serving.validation import ValidatedRequest
from gat_recommendation_torch.train import checkpoint as ckpt


def _repo_root() -> Path:
    return Path(__file__).resolve().parents[2]


class Recommender:
    """Loads a model checkpoint and the co-occurrence graph; serves top-k.

    `device` is where the model runs: ``cuda`` when None (raises without a
    CUDA device); the CPU only when the caller passes ``device="cpu"``.
    """

    def __init__(
        self,
        checkpoint_path: Path | str,
        graph_edges_path: Path | str,
        buckets: tuple[int, ...] = (8, 16, 32, 56),
        warmup: bool = True,
        device=None,
    ):
        self.device = resolve_device(device)
        self.buckets = tuple(buckets)
        self._load_model(Path(checkpoint_path))
        self._load_graph(Path(graph_edges_path))
        if warmup:
            # One request per bucket up front: builds the kernels and warms
            # the allocator, so the first real request pays neither.
            for b in self.buckets:
                self.recommend(
                    ValidatedRequest(session_items=[1, 2], k=DEFAULT_LIMITS.default_k),
                    _force_bucket=b,
                )

    @classmethod
    def from_default(cls, **kwargs) -> "Recommender":
        root = _repo_root()
        return cls(
            root / "checkpoints" / "best_model_torch",
            root / "data" / "processed" / "graph_edges.csv",
            **kwargs,
        )

    def _load_model(self, checkpoint_path: Path) -> None:
        meta = ckpt.load_meta(checkpoint_path)
        cfg = dict(meta["model_config"])
        if cfg.get("use_ffn"):
            raise RuntimeError(
                "This Recommender targets the optimized (no-FFN) checkpoint, but the "
                "given checkpoint has FFN layers. Load the optimized model instead."
            )
        num_items = cfg.pop("num_items")
        model = create_model(meta["model_name"], num_items, device="meta", **cfg)
        self.model = ckpt.restore_params_state(checkpoint_path, model, self.device).eval()

        table = self.model.item_embedding
        self.num_items, self.embedding_dim = num_items, int(table.shape[1])
        if int(table.shape[0]) != padded_rows(num_items):
            raise ValueError(
                f"checkpoint table has {table.shape[0]} rows; num_items={num_items} "
                f"pads to {padded_rows(num_items)}"
            )
        self.checkpoint_epoch = int(meta.get("epoch", -1))
        self.val_recall_at_10 = float(meta.get("best_val_metric", float("nan")))

    def _load_graph(self, graph_edges_path: Path) -> None:
        item_i, item_j = load_edges(graph_edges_path)
        keep = item_i != item_j  # self-loops are not messages
        self.graph = build_csr(item_i[keep], item_j[keep], self.num_items)

    def _build_session_batch(self, items: list[int], bucket_n: int) -> SessionBatch:
        nodes = np.unique(np.asarray(items, dtype=np.int64))
        n = min(len(nodes), bucket_n)
        nodes = nodes[:n]
        src, dst = induced_edges(self.graph, nodes)

        node_ids = np.zeros((1, bucket_n), np.int32)
        node_ids[0, :n] = nodes
        node_mask = np.zeros((1, bucket_n), bool)
        node_mask[0, :n] = True
        adj = np.zeros((1, bucket_n, bucket_n), bool)
        adj[0, dst, src] = True
        host = SessionBatch(
            torch.from_numpy(node_ids),
            torch.from_numpy(node_mask),
            torch.from_numpy(adj),
            torch.tensor([n], dtype=torch.int32),
        )
        return host.to(self.device)

    def recommend(
        self, request: ValidatedRequest, _force_bucket: int | None = None
    ) -> tuple[list[int], list[float]]:
        """Return (item_ids, scores) for the top-k recommendations, best first."""
        items = request.session_items
        bucket_n = _force_bucket or pick_bucket(len(set(items)), self.buckets)
        batch = self._build_session_batch(items, bucket_n)

        exclude = np.zeros((padded_rows(self.num_items),), np.uint8)
        exclude[list(set(items))] = 1
        exclude[0] = 1  # padding index
        exclude = torch.from_numpy(exclude).to(self.device)

        with torch.inference_mode():
            sess = self.model(batch)
            top_scores, top_idx = full_catalog_topk(
                sess, self.model.item_embedding, request.k, self.num_items, exclude=exclude
            )
        return top_idx[0].tolist(), top_scores[0].tolist()

    def health(self) -> dict:
        return {
            "num_items": self.num_items,
            "embedding_dim": self.embedding_dim,
            "checkpoint_epoch": self.checkpoint_epoch,
            "val_recall_at_10": self.val_recall_at_10,
            # No int8 candidate scorer yet (ROADMAP A7): every score is float32.
            "int8_scoring": False,
            "device": str(self.device),
        }
