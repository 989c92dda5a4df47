"""The port's serving monitoring (``serving/monitoring.py``) against the JAX package's.

``DriftDetector.report()`` must equal the JAX detector's dict on the same
record stream: before either window holds 30 records, once both do (KS
statistics from scipy), and with a shifted stream that flags score drift.

``Metrics`` registers in prometheus_client's default registry, which holds
one metric of a name per process, and the JAX package's Vertex server (which
its own tests load) registers the same names. So every check that makes a
``Metrics`` runs in a fresh interpreter: one for each package with
prometheus_client, and one without it (the no-op fallback of the card's
host). The exposition must list the same metric names and the same samples
(the ``*_created`` timestamps aside).
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from gat_recommendation_torch.serving import monitoring as port_mon
from gat_recommendation_tpu.serving import monitoring as jax_mon

REPO = Path(__file__).resolve().parents[1]


def _stream(seed, n, shift_after=None):
    rng = np.random.default_rng(seed)
    for i in range(n):
        mean = 5.0 if shift_after is not None and i >= shift_after else 0.0
        yield float(rng.normal(mean, 1)), int(rng.integers(2, 10)), int(rng.integers(1, 6))


@pytest.mark.parametrize("n,shift_after", [(0, None), (10, None), (40, None), (69, None), (75, None),
                                           (120, None), (120, 40)])
def test_drift_report_equals_the_jax_detectors(n, shift_after):
    kw = dict(reference_size=40, window_size=50, threshold=0.2)
    port, ref = port_mon.DriftDetector(**kw), jax_mon.DriftDetector(**kw)
    for record in _stream(n, n, shift_after):
        port.record(*record)
        ref.record(*record)
    got, want = port.report(), ref.report()
    assert got == want
    assert got["sufficient_data"] == (n >= 70)
    if shift_after is not None:
        assert got["score_drift_detected"] is True


_METRICS_PROBE = """
import json, sys
if sys.argv[2] == "absent":
    sys.modules["prometheus_client"] = None
mod = __import__(sys.argv[1], fromlist=["Metrics"])
m = mod.Metrics()
m.observe("/recommend", "200", 0.0125)
m.observe("/recommend", "400", 0.5)
m.observe("/predict", "200", 0.002)
d = mod.DriftDetector(reference_size=30, window_size=30, metrics=m)
for i in range(70):
    d.record(float(i % 7), 2 + i % 5, i % 3)
report = d.report()
text = m.exposition().decode()
ours = ("recommend_", "drift_", "top1_")
print(json.dumps({
    "enabled": m.enabled,
    "report": report,
    "text": text if not m.enabled else None,
    "names": sorted(line.split()[2] for line in text.splitlines() if line.startswith("# TYPE")),
    "samples": sorted(line for line in text.splitlines()
                      if line.startswith(ours) and "_created" not in line),
}))
"""


def _probe(module: str, prometheus: str) -> dict:
    out = subprocess.run([sys.executable, "-c", _METRICS_PROBE, module, prometheus], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("prometheus", ["present", "absent"])
def test_metrics_exposition_lists_the_jax_metrics(prometheus):
    got = _probe("gat_recommendation_torch.serving.monitoring", prometheus)
    want = _probe("gat_recommendation_tpu.serving.monitoring", prometheus)
    assert got == want
    if prometheus == "present":
        assert got["enabled"] is True
        assert {"recommend_requests_total", "recommend_latency_seconds", "drift_score_ks",
                "drift_session_length_ks", "top1_item_entropy"} <= set(got["names"])
        assert 'recommend_requests_total{endpoint="/recommend",status="400"} 1.0' in got["samples"]
    else:
        assert got["enabled"] is False and got["text"] == "# prometheus_client not installed\n"
    assert got["report"]["sufficient_data"] is True
