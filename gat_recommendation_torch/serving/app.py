"""Thin serving app: request -> validate_request -> Recommender.recommend -> response.

Routes and status codes: ``GET /health``; ``POST /recommend`` answers 503
when no model is loaded, 422 when validation fails, 400 on a body that is
not JSON; 404 for any other route. The route logic is the transport-free
``handle_request``; the transport is the stdlib ``ThreadingHTTPServer``
(``python -m gat_recommendation_torch.serving.app``).
"""

from __future__ import annotations

import json
import time
from typing import Any

from gat_recommendation_torch.serving.config import DEFAULT_LIMITS
from gat_recommendation_torch.serving.validation import InputValidationError, validate_request

_state: dict = {"recommender": None}


def load_default_recommender() -> None:
    from gat_recommendation_torch.serving.recommender import Recommender

    try:
        _state["recommender"] = Recommender.from_default()
    except Exception as exc:  # keep /health alive, 503 on /recommend
        print(f"[serving] model not loaded: {exc!r}")
        _state["recommender"] = None


def set_recommender(rec) -> None:
    _state["recommender"] = rec


class _Request:
    def __init__(self, session_items, k=None):
        self.session_items = session_items
        self.k = k


def handle_request(method: str, path: str, body: dict | None) -> tuple[int, dict[str, Any]]:
    """Transport-free route logic. Returns (status_code, response_dict)."""
    rec = _state["recommender"]

    if method == "GET" and path == "/health":
        return 200, {
            "status": "ok" if rec is not None else "unavailable",
            "model_loaded": rec is not None,
            "num_items": rec.num_items if rec else 0,
            "embedding_dim": rec.embedding_dim if rec else 0,
            **({"checkpoint_epoch": rec.checkpoint_epoch,
                "val_recall_at_10": rec.val_recall_at_10} if rec else {}),
        }

    if method == "POST" and path == "/recommend":
        if rec is None:
            return 503, {"detail": "Model is not loaded."}
        if not isinstance(body, dict) or "session_items" not in body:
            return 422, {"detail": "body must be JSON with a session_items list."}
        if not isinstance(body["session_items"], list):
            return 422, {"detail": "session_items must be a list."}
        req = _Request(body["session_items"], body.get("k"))
        if req.k is not None and (isinstance(req.k, bool) or not isinstance(req.k, int)):
            return 422, {"detail": "k must be an integer."}
        try:
            validated = validate_request(req, rec.num_items, DEFAULT_LIMITS)
        except InputValidationError as exc:
            return 422, {"detail": str(exc)}

        start = time.perf_counter()
        recommendations, scores = rec.recommend(validated)
        latency_ms = (time.perf_counter() - start) * 1000
        return 200, {
            "recommendations": recommendations,
            "scores": scores,
            "latency_ms": round(latency_ms, 3),
            "dropped_items": validated.dropped_items,
            "truncated": validated.truncated,
        }

    return 404, {"detail": f"no route {method} {path}"}


def make_server(host: str = "127.0.0.1", port: int = 0, load_model: bool = True):
    """Build (but don't start) the stdlib server; port 0 picks a free port."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    if load_model:
        load_default_recommender()

    class Handler(BaseHTTPRequestHandler):
        def _send(self, status: int, payload: dict) -> None:
            data = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):  # noqa: N802
            self._send(*handle_request("GET", self.path, None))

        def do_POST(self):  # noqa: N802
            length = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(length) if length else b""
            try:
                body = json.loads(raw) if raw else None
            except json.JSONDecodeError:
                self._send(400, {"detail": "invalid JSON body."})
                return
            self._send(*handle_request("POST", self.path, body))

        def log_message(self, fmt, *args):  # quiet
            pass

    return ThreadingHTTPServer((host, port), Handler)


def serve(host: str = "0.0.0.0", port: int = 8000, load_model: bool = True):
    """Run the stdlib ThreadingHTTPServer (blocking)."""
    server = make_server(host, port, load_model=load_model)
    print(f"[serving] listening on {host}:{port}")
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    args = parser.parse_args()
    serve(args.host, args.port)
