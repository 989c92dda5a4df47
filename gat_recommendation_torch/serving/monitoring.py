"""Serving observability: Prometheus metrics and drift detection.

The JAX package's ``serving/monitoring.py``, for the port's Vertex-style
server (``scripts/serve/vertex_app.py``). ``Metrics`` registers its counters,
histogram and gauges in prometheus_client's default registry, which holds
one metric of a name per process, so a process makes one ``Metrics``; where
prometheus_client is absent (as on the card's host) it is a no-op.
``DriftDetector`` compares a fixed reference window with a rolling recent
window by two-sample KS statistics (scipy) of the top score and the session
length, and reports the entropy of the top-1 items.
"""

from __future__ import annotations

import math
import threading
from collections import Counter, deque


class Metrics:
    """Prometheus metrics with a no-op fallback when the client is absent."""

    def __init__(self):
        try:
            from prometheus_client import Counter as PCounter
            from prometheus_client import Gauge, Histogram, generate_latest

            self._generate = generate_latest
            self.request_count = PCounter(
                "recommend_requests_total", "Total recommendation requests", ["endpoint", "status"]
            )
            self.request_latency = Histogram(
                "recommend_latency_seconds", "Request latency", ["endpoint"]
            )
            self.drift_score_stat = Gauge("drift_score_ks", "KS statistic of score distribution")
            self.drift_length_stat = Gauge("drift_session_length_ks", "KS statistic of session length")
            self.drift_entropy = Gauge("top1_item_entropy", "Entropy of top-1 recommendations")
            self.enabled = True
        except ImportError:
            self.enabled = False

    def observe(self, endpoint: str, status: str, latency_s: float) -> None:
        if self.enabled:
            self.request_count.labels(endpoint=endpoint, status=status).inc()
            self.request_latency.labels(endpoint=endpoint).observe(latency_s)

    def exposition(self) -> bytes:
        if not self.enabled:
            return b"# prometheus_client not installed\n"
        return self._generate()


class DriftDetector:
    """Reference-window vs rolling-window drift on scores / lengths / top-1 entropy.

    The first `reference_size` requests define the reference distribution;
    the latest `window_size` requests form the comparison window; drift is
    flagged when the KS statistic exceeds `threshold`, once both windows
    hold 30 requests.
    """

    def __init__(self, reference_size: int = 5000, window_size: int = 1000,
                 threshold: float = 0.2, metrics: Metrics | None = None):
        self.reference_size = reference_size
        self.window_size = window_size
        self.threshold = threshold
        self.metrics = metrics
        self._lock = threading.Lock()
        self.ref_scores: list[float] = []
        self.ref_lengths: list[int] = []
        self.win_scores: deque = deque(maxlen=window_size)
        self.win_lengths: deque = deque(maxlen=window_size)
        self.top1_counts: Counter = Counter()
        self.n_seen = 0

    def record(self, top_score: float, session_length: int, top1_item: int) -> None:
        with self._lock:
            self.n_seen += 1
            if len(self.ref_scores) < self.reference_size:
                self.ref_scores.append(top_score)
                self.ref_lengths.append(session_length)
            else:
                self.win_scores.append(top_score)
                self.win_lengths.append(session_length)
            self.top1_counts[top1_item] += 1

    @staticmethod
    def _ks(a, b) -> float:
        try:
            from scipy.stats import ks_2samp

            return float(ks_2samp(list(a), list(b)).statistic)
        except ImportError:
            return 0.0

    def top1_entropy(self) -> float:
        total = sum(self.top1_counts.values())
        if total == 0:
            return 0.0
        return -sum(
            (c / total) * math.log2(c / total) for c in self.top1_counts.values()
        )

    def report(self) -> dict:
        with self._lock:
            enough = len(self.ref_scores) >= 30 and len(self.win_scores) >= 30
            score_ks = self._ks(self.ref_scores, self.win_scores) if enough else 0.0
            length_ks = self._ks(self.ref_lengths, self.win_lengths) if enough else 0.0
            entropy = self.top1_entropy()
            if self.metrics is not None and self.metrics.enabled:
                self.metrics.drift_score_stat.set(score_ks)
                self.metrics.drift_length_stat.set(length_ks)
                self.metrics.drift_entropy.set(entropy)
            return {
                "requests_seen": self.n_seen,
                "reference_window": len(self.ref_scores),
                "rolling_window": len(self.win_scores),
                "sufficient_data": enough,
                "score_ks_statistic": score_ks,
                "session_length_ks_statistic": length_ks,
                "score_drift_detected": enough and score_ks > self.threshold,
                "length_drift_detected": enough and length_ks > self.threshold,
                "top1_item_entropy": entropy,
                "threshold": self.threshold,
            }
