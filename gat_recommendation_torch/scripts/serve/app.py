#!/usr/bin/env python3
"""Dev server: mean-of-item-embeddings recommendations over stdlib HTTP.

    python3 -m gat_recommendation_torch.scripts.serve.app [--checkpoint DIR | --embeddings FILE.npy]
        [--host 0.0.0.0] [--port 8080] [--device cpu]

Loads the item table of a checkpoint in the port's format (``meta.json`` +
``tensors.pt``), of an ``.npy`` file, or a random demo table, and serves
recommendations by the mean of the session's item embeddings and cosine
scores over the whole catalog: deliberately not the GNN, which
``gat_recommendation_torch.serving.app`` serves. Routes: GET /health,
POST /recommend, POST /recommend/batch. The table and its scores live on the
card unless ``--device cpu``. The port of the repo's ``scripts/serve/app.py``.
"""

from __future__ import annotations

import argparse
import json
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import torch

from gat_recommendation_torch.device import resolve_device


class MeanEmbeddingModel:
    """Session = mean of its valid items' embeddings; scores = cosine similarity.

    The table and its row-normalised copy live on `device` (``cuda`` when
    None, which raises without one; the CPU for ``device="cpu"``). The top-k
    is a stable descending sort: tied scores come out lowest id first.
    """

    def __init__(self, item_embeddings, device=None):
        self.device = resolve_device(device)
        self.item_embeddings = torch.as_tensor(np.asarray(item_embeddings, dtype=np.float32)).to(self.device)
        norms = torch.linalg.vector_norm(self.item_embeddings, dim=1, keepdim=True)
        self._normed = self.item_embeddings / norms.clamp_min(1e-12)
        self.num_items, self.embedding_dim = self.item_embeddings.shape

    @classmethod
    def demo(cls, num_items: int = 10_000, dim: int = 256, seed: int = 42, device=None):
        rng = np.random.default_rng(seed)
        return cls(rng.standard_normal((num_items, dim)).astype(np.float32), device)

    @classmethod
    def from_checkpoint(cls, ckpt_dir: str, device=None):
        """The item table of a checkpoint in the port's format (phantom rows included)."""
        from gat_recommendation_torch.models.registry import create_model
        from gat_recommendation_torch.train import checkpoint as ckpt

        meta = ckpt.load_meta(ckpt_dir)
        cfg = dict(meta["model_config"])
        model = create_model(meta["model_name"], cfg.pop("num_items"), device="meta", **cfg)
        model = ckpt.restore_params_state(ckpt_dir, model, "cpu")
        return cls(model.item_embedding.detach().numpy(), device)

    @classmethod
    def from_npy(cls, path: str, device=None):
        return cls(np.load(path), device)

    def recommend(self, session_items: list[int], k: int) -> tuple[list[int], list[float]]:
        valid = [i for i in session_items if 0 < i < self.num_items]
        if not valid:
            raise ValueError("no valid item ids in session")
        idx = torch.tensor(valid, device=self.device)
        sess = self.item_embeddings[idx].mean(dim=0)
        sess = sess / torch.linalg.vector_norm(sess).clamp_min(1e-12)
        scores = self._normed @ sess
        scores[idx] = -torch.inf
        scores[0] = -torch.inf
        top = torch.sort(scores, descending=True, stable=True).indices[:k]
        return top.tolist(), scores[top].tolist()


def handle(model, method: str, path: str, body: dict | None) -> tuple[int, dict]:
    if method == "GET" and path == "/health":
        return 200, {"status": "ok", "model_loaded": True,
                     "num_items": model.num_items, "embedding_dim": model.embedding_dim}

    if method == "POST" and path == "/recommend":
        items = (body or {}).get("session_items")
        if not items or not isinstance(items, list):
            return 400, {"detail": "session_items must be a non-empty list"}
        k = (body or {}).get("k", 10)
        try:
            t0 = time.perf_counter()
            recs, scores = model.recommend(items, int(k))
            return 200, {"recommendations": recs, "scores": scores,
                         "latency_ms": round((time.perf_counter() - t0) * 1000, 3)}
        except ValueError as e:
            return 400, {"detail": str(e)}

    if method == "POST" and path == "/recommend/batch":
        sessions = (body or {}).get("sessions")
        if not isinstance(sessions, list):
            return 400, {"detail": "sessions must be a list"}
        k = (body or {}).get("k", 10)
        out = []
        for s in sessions:
            try:
                recs, scores = model.recommend(s, int(k))
                out.append({"recommendations": recs, "scores": scores})
            except ValueError as e:
                out.append({"error": str(e)})
        return 200, {"results": out}

    return 404, {"detail": f"no route {method} {path}"}


def make_server(model, host: str = "127.0.0.1", port: int = 0) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def _send(self, status, payload):
            data = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):  # noqa: N802
            self._send(*handle(model, "GET", self.path, None))

        def do_POST(self):  # noqa: N802
            length = int(self.headers.get("Content-Length", 0))
            try:
                body = json.loads(self.rfile.read(length)) if length else None
            except json.JSONDecodeError:
                self._send(400, {"detail": "invalid JSON"})
                return
            self._send(*handle(model, "POST", self.path, body))

        def log_message(self, *a):
            pass

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Dev recommendation server")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--checkpoint", type=str, default=None)
    parser.add_argument("--embeddings", type=str, default=None)
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    if args.checkpoint and Path(args.checkpoint).exists():
        model = MeanEmbeddingModel.from_checkpoint(args.checkpoint, args.device)
        print(f"loaded checkpoint {args.checkpoint}")
    elif args.embeddings and Path(args.embeddings).exists():
        model = MeanEmbeddingModel.from_npy(args.embeddings, args.device)
        print(f"loaded embeddings {args.embeddings}")
    else:
        model = MeanEmbeddingModel.demo(device=args.device)
        print("using demo model (random embeddings)")

    server = make_server(model, args.host, args.port)
    print(f"dev server listening on {args.host}:{args.port} ({model.device})")
    server.serve_forever()


if __name__ == "__main__":
    main()
