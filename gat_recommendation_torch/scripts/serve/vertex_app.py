#!/usr/bin/env python3
"""Vertex-style production server: mean-embedding recommendations over stdlib HTTP.

    python3 -m gat_recommendation_torch.scripts.serve.vertex_app [--device cpu]

Configured from the environment: PORT (or AIP_HTTP_PORT), INFERENCE_MODE
(embeddings | checkpoint | demo), GCS_MODEL_URI or AIP_STORAGE_URI (artifacts
downloaded into MODEL_DIR at start, through google-cloud-storage imported
inside the call), AIP_PREDICT_ROUTE, AIP_HEALTH_ROUTE and DRIFT_*. The
model is the dev server's ``MeanEmbeddingModel`` (the table on the card
unless ``--device cpu``): from MODEL_DIR/item_embeddings.npy, from
MODEL_DIR/checkpoint_best in the port's checkpoint format, or a demo table.
Routes: the Vertex ``/predict`` instances format, GET /health, POST
/recommend and /recommend/batch, Prometheus GET /metrics and the drift
report GET /drift (``serving/monitoring.py``; a no-op ``Metrics`` where
prometheus_client is absent), and a server span around every request when
OpenTelemetry is installed. The port of the repo's ``scripts/serve/vertex_app.py``.

Importing this module registers the process's one ``Metrics``.
"""

import argparse
import json
import os
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

from gat_recommendation_torch.scripts.serve.app import MeanEmbeddingModel
from gat_recommendation_torch.serving.monitoring import DriftDetector, Metrics

# ---------------------------------------------------------------------------
# Env config
# ---------------------------------------------------------------------------
PORT = int(os.environ.get("PORT", os.environ.get("AIP_HTTP_PORT", 8080)))
INFERENCE_MODE = os.environ.get("INFERENCE_MODE", "embeddings")  # embeddings|checkpoint|demo
GCS_MODEL_URI = os.environ.get("GCS_MODEL_URI", "")
AIP_STORAGE_URI = os.environ.get("AIP_STORAGE_URI", "")
MODEL_DIR = Path(os.environ.get("MODEL_DIR", "model_artifacts"))
PREDICT_ROUTE = os.environ.get("AIP_PREDICT_ROUTE", "/predict")
HEALTH_ROUTE = os.environ.get("AIP_HEALTH_ROUTE", "/health")

metrics = Metrics()
drift = DriftDetector(
    reference_size=int(os.environ.get("DRIFT_REFERENCE_SIZE", 5000)),
    window_size=int(os.environ.get("DRIFT_WINDOW_SIZE", 1000)),
    threshold=float(os.environ.get("DRIFT_THRESHOLD", 0.2)),
    metrics=metrics,
)

_tracer = None


def setup_tracing() -> None:
    """OpenTelemetry tracing where it is installed, else none.

    A Cloud Trace span exporter is attached when its package and a project
    are available, and every HTTP request gets a server span (the request
    handlers wrap handle() in `_request_span`).
    """
    global _tracer
    try:
        from opentelemetry import trace
        from opentelemetry.sdk.trace import TracerProvider

        provider = TracerProvider()
        exporter = None
        try:  # the Cloud Trace exporter, an optional package
            from opentelemetry.exporter.cloud_trace import CloudTraceSpanExporter
            from opentelemetry.sdk.trace.export import BatchSpanProcessor

            project = os.environ.get("GOOGLE_CLOUD_PROJECT")
            exporter = CloudTraceSpanExporter(project_id=project) if project else None
            if exporter is not None:
                provider.add_span_processor(BatchSpanProcessor(exporter))
        except Exception:
            pass
        trace.set_tracer_provider(provider)
        _tracer = trace.get_tracer("vertex_app")
        print(
            "[vertex] OpenTelemetry tracing enabled"
            + (" (Cloud Trace export on)" if exporter is not None else " (no exporter)")
        )
    except Exception as e:
        print(f"[vertex] tracing disabled: {e}")


class _request_span:
    """Server span around one HTTP request."""

    def __init__(self, method: str, path: str):
        self.span = _tracer.start_span(f"{method} {path}") if _tracer else None
        if self.span:
            self.span.set_attribute("http.request.method", method)
            self.span.set_attribute("url.path", path)

    def set_status(self, status: int) -> None:
        if self.span:
            self.span.set_attribute("http.response.status_code", status)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.span:
            self.span.end()
        return False


def download_from_gcs(uri: str, dest: Path) -> None:
    """Pull gs://bucket/prefix artifacts to dest."""
    from google.cloud import storage  # type: ignore

    assert uri.startswith("gs://")
    bucket_name, _, prefix = uri[5:].partition("/")
    client = storage.Client()
    for blob in client.list_blobs(bucket_name, prefix=prefix):
        target = dest / Path(blob.name).name
        target.parent.mkdir(parents=True, exist_ok=True)
        blob.download_to_filename(str(target))
        print(f"[vertex] downloaded gs://{bucket_name}/{blob.name}")


def load_model(device=None) -> MeanEmbeddingModel:
    """The model of INFERENCE_MODE, its table on `device` (cuda when None)."""
    uri = GCS_MODEL_URI or AIP_STORAGE_URI
    if uri:
        try:
            download_from_gcs(uri, MODEL_DIR)
        except Exception as e:
            print(f"[vertex] GCS download failed: {e}")

    if INFERENCE_MODE == "demo":
        return MeanEmbeddingModel.demo(device=device)
    if INFERENCE_MODE == "checkpoint":
        return MeanEmbeddingModel.from_checkpoint(str(MODEL_DIR / "checkpoint_best"), device)
    npy = MODEL_DIR / "item_embeddings.npy"
    if npy.exists():
        return MeanEmbeddingModel.from_npy(str(npy), device)
    print("[vertex] no artifacts found; falling back to demo model")
    return MeanEmbeddingModel.demo(device=device)


def compute_recommendations(model, session_items: list[int], k: int) -> dict:
    """One session -> recommendations, and its record in the drift detector."""
    span = _tracer.start_span("compute_recommendations") if _tracer else None
    if span:
        span.set_attribute("session.length", len(session_items))
        span.set_attribute("k", k)
    try:
        t0 = time.perf_counter()
        recs, scores = model.recommend(session_items, k)
        latency_ms = (time.perf_counter() - t0) * 1000
        drift.record(scores[0] if scores else 0.0, len(session_items), recs[0] if recs else 0)
        if span:
            span.set_attribute("latency_ms", latency_ms)
        return {"recommendations": recs, "scores": scores,
                "latency_ms": round(latency_ms, 3)}
    finally:
        if span:
            span.end()


def handle(model, method: str, path: str, body: dict | None) -> tuple[int, object]:
    if method == "GET" and path == HEALTH_ROUTE:
        return 200, {"status": "ok", "model_loaded": True,
                     "num_items": model.num_items, "embedding_dim": model.embedding_dim,
                     "inference_mode": INFERENCE_MODE}

    if method == "GET" and path == "/metrics":
        return 200, metrics.exposition()

    if method == "GET" and path == "/drift":
        return 200, drift.report()

    if method == "POST" and path == PREDICT_ROUTE:
        # Vertex instances format: {"instances": [{"session_items": [...], "k": 10}, ...]}
        instances = (body or {}).get("instances")
        if not isinstance(instances, list):
            return 400, {"detail": "body must contain an instances list"}
        predictions = []
        for inst in instances:
            try:
                predictions.append(
                    compute_recommendations(model, inst.get("session_items", []),
                                            int(inst.get("k", 10)))
                )
            except (ValueError, TypeError) as e:
                predictions.append({"error": str(e)})
        return 200, {"predictions": predictions}

    if method == "POST" and path == "/recommend":
        items = (body or {}).get("session_items")
        if not items or not isinstance(items, list):
            return 400, {"detail": "session_items must be a non-empty list"}
        try:
            return 200, compute_recommendations(model, items, int((body or {}).get("k", 10)))
        except (ValueError, TypeError) as e:
            return 400, {"detail": str(e)}

    if method == "POST" and path == "/recommend/batch":
        sessions = (body or {}).get("sessions")
        if not isinstance(sessions, list):
            return 400, {"detail": "sessions must be a list"}
        results = []
        for s in sessions:
            try:
                results.append(compute_recommendations(model, s, int((body or {}).get("k", 10))))
            except (ValueError, TypeError) as e:
                results.append({"error": str(e)})
        return 200, {"results": results}

    return 404, {"detail": f"no route {method} {path}"}


def make_server(model, host: str = "0.0.0.0", port: int = PORT):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, status, payload):
            if isinstance(payload, bytes):  # /metrics exposition
                self.send_response(status)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)
                return
            data = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _observe(self, path, status, t0):
            metrics.observe(path, str(status), time.perf_counter() - t0)

        def do_GET(self):  # noqa: N802
            t0 = time.perf_counter()
            with _request_span("GET", self.path) as span:
                status, payload = handle(model, "GET", self.path, None)
                span.set_status(status)
            self._send(status, payload)
            self._observe(self.path, status, t0)

        def do_POST(self):  # noqa: N802
            t0 = time.perf_counter()
            length = int(self.headers.get("Content-Length", 0))
            try:
                body = json.loads(self.rfile.read(length)) if length else None
            except json.JSONDecodeError:
                self._send(400, {"detail": "invalid JSON"})
                self._observe(self.path, 400, t0)
                return
            with _request_span("POST", self.path) as span:
                status, payload = handle(model, "POST", self.path, body)
                span.set_status(status)
            self._send(status, payload)
            self._observe(self.path, status, t0)

        def log_message(self, *a):
            pass

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Vertex-style recommendation server (configured from the environment)")
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    setup_tracing()
    model = load_model(args.device)
    server = make_server(model)
    print(f"[vertex] listening on :{PORT} (mode={INFERENCE_MODE}, "
          f"num_items={model.num_items})")
    server.serve_forever()


if __name__ == "__main__":
    main()
