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
buckets.

On a CPU host with a catalog of at least ``FAST_SCORING_MIN_ROWS`` rows the
full-catalog scan runs, as in the JAX package, through the int8 candidate
scorer of the port's C++ library (``native/scorer.cpp``: a quarter of the
float32 table's bytes) and an exact float32 re-rank of its top
``max(FAST_SCORING_CANDIDATES, 8k)`` rows. The GNN forward runs on the
Recommender's device either way (kernel 1 on the card).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from gat_recommendation_torch.data import native
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


# Below this catalog size the full float32 scan is already cheap and the int8
# candidate path would only add moving parts.
FAST_SCORING_MIN_ROWS = 100_000
# Candidate margin of the int8 path: top-k membership is decided at L >> k,
# where the int8 rounding error cannot demote a true top-k item out of the
# candidates; the final order is re-ranked exactly in float32.
FAST_SCORING_CANDIDATES = 1024


class Recommender:
    """Loads a model checkpoint and the co-occurrence graph; serves top-k.

    `device` is where the model runs: ``cuda`` when None (raises without a
    CUDA device); the CPU only when the caller passes ``device="cpu"``.

    `int8_scoring` "auto" (the default) scans the catalog with the int8
    candidate scorer when the device is the CPU, the table has at least
    ``FAST_SCORING_MIN_ROWS`` rows and the C++ library builds; True forces
    that path on any device (the forward stays on the device, the scan runs
    on the host) and raises without the library; False always scores the
    whole catalog in float32 on the device (kernel 2 on the card).
    """

    def __init__(
        self,
        checkpoint_path: Path | str,
        graph_edges_path: Path | str,
        buckets: tuple[int, ...] = (8, 16, 32, 56),
        warmup: bool = True,
        device=None,
        int8_scoring: bool | str = "auto",
    ):
        self.device = resolve_device(device)
        self.buckets = tuple(buckets)
        self._load_model(Path(checkpoint_path))
        self._load_graph(Path(graph_edges_path))
        self._setup_fast_scoring(int8_scoring)
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

    def _setup_fast_scoring(self, int8_scoring: bool | str) -> None:
        if int8_scoring not in (True, False, "auto"):
            raise ValueError(f"int8_scoring must be True, False or 'auto', got {int8_scoring!r}")
        if int8_scoring is True and not native.available():
            raise RuntimeError("int8_scoring=True, but the C++ library (native/scorer.cpp) does not build here")
        rows = int(self.model.item_embedding.shape[0])
        self.int8_scoring = int8_scoring is True or (
            int8_scoring == "auto" and self.device.type == "cpu" and rows >= FAST_SCORING_MIN_ROWS
            and native.available()
        )
        if not self.int8_scoring:
            return
        # Once at load: the float32 host copy (the re-rank reads it) and the
        # int8 copy with per-row scales. The padding row 0 and the phantom
        # rows past num_items get scale 0, so they are never candidates.
        self._table_np = np.ascontiguousarray(self.model.item_embedding.detach().cpu().numpy(), dtype=np.float32)
        self._q, self._q_scale, self._q_rowsum = native.quantize_table(self._table_np)
        self._q_scale[0] = 0.0
        self._q_scale[self.num_items:] = 0.0

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

        if self.int8_scoring:
            return self._recommend_int8(batch, items, request.k)

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

    def _recommend_int8(self, batch: SessionBatch, items: list[int], k: int) -> tuple[list[int], list[float]]:
        """The model forward on the device without catalog scoring, the int8
        candidate scan on the host, then the exact float32 re-rank of the
        candidates (a stable descending sort, cut at k)."""
        with torch.inference_mode():
            sess = self.model(batch)[0].cpu().numpy()
        seen = np.zeros((self._table_np.shape[0],), np.uint8)
        seen[list(set(items))] = 1
        L = max(FAST_SCORING_CANDIDATES, 8 * k)
        cand, _ = native.score_int8_topl(self._q, self._q_scale, self._q_rowsum, sess, L, seen=seen)
        exact = self._table_np[cand] @ sess
        order = np.argsort(-exact, kind="stable")[:k]
        return cand[order].tolist(), exact[order].astype(float).tolist()

    def health(self) -> dict:
        return {
            "num_items": self.num_items,
            "embedding_dim": self.embedding_dim,
            "checkpoint_epoch": self.checkpoint_epoch,
            "val_recall_at_10": self.val_recall_at_10,
            "int8_scoring": self.int8_scoring,
            "device": str(self.device),
        }
