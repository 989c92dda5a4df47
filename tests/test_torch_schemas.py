"""The port's serving schemas (``serving/schemas.py``) against the JAX package's.

Both branches: the pydantic models (pydantic is installed here), and, in a
fresh interpreter with pydantic hidden, the dataclass fallback that the
card's host (no pydantic) runs. Each class must have the same fields and
defaults as the JAX class, build from the same arguments, and dump the same
dict; the pydantic branch must refuse what the JAX models refuse.
"""

import json
import subprocess
import sys
from pathlib import Path

import pydantic
import pytest

from gat_recommendation_torch.serving import schemas as port_schemas
from gat_recommendation_tpu.serving import schemas as jax_schemas

REPO = Path(__file__).resolve().parents[1]

CLASSES = ("RecommendRequest", "RecommendResponse", "HealthResponse")
CASES = [
    ("RecommendRequest", {"session_items": [3, 1, 3]}),
    ("RecommendRequest", {"session_items": [5], "k": 7}),
    ("RecommendResponse", {"recommendations": [4, 2], "scores": [0.5, 0.25], "latency_ms": 1.5}),
    ("RecommendResponse", {"recommendations": [4], "scores": [0.5], "latency_ms": 2.0,
                           "dropped_items": [99], "truncated": True}),
    ("HealthResponse", {"status": "ok", "model_loaded": True, "num_items": 10, "embedding_dim": 8}),
]


def test_pydantic_branch_has_the_jax_fields_and_dumps():
    assert port_schemas.PYDANTIC is jax_schemas.PYDANTIC is True
    for name in CLASSES:
        got, want = getattr(port_schemas, name), getattr(jax_schemas, name)
        assert list(got.model_fields) == list(want.model_fields), name
        for field, info in want.model_fields.items():
            assert got.model_fields[field].annotation == info.annotation, (name, field)
            assert got.model_fields[field].is_required() == info.is_required(), (name, field)
            assert got.model_fields[field].get_default(call_default_factory=True) == \
                info.get_default(call_default_factory=True), (name, field)
    for name, kwargs in CASES:
        got = getattr(port_schemas, name)(**kwargs).model_dump()
        assert got == getattr(jax_schemas, name)(**kwargs).model_dump()


@pytest.mark.parametrize("kwargs", [{}, {"session_items": "abc"}, {"session_items": [1], "k": "many"}])
def test_pydantic_branch_refuses_what_the_jax_models_refuse(kwargs):
    with pytest.raises(pydantic.ValidationError):
        jax_schemas.RecommendRequest(**kwargs)
    with pytest.raises(pydantic.ValidationError):
        port_schemas.RecommendRequest(**kwargs)


_FALLBACK_PROBE = """
import dataclasses, json, sys
sys.modules["pydantic"] = None
mod = __import__(sys.argv[1], fromlist=["PYDANTIC"])
cases = json.loads(sys.argv[2])
fields = {}
for name in ("RecommendRequest", "RecommendResponse", "HealthResponse"):
    cls = getattr(mod, name)
    fields[name] = [[f.name, str(f.type),
                     None if f.default is dataclasses.MISSING else f.default,
                     None if f.default_factory is dataclasses.MISSING else f.default_factory()]
                    for f in dataclasses.fields(cls)]
dumps = [dataclasses.asdict(getattr(mod, name)(**kwargs)) for name, kwargs in cases]
print(json.dumps({"pydantic": mod.PYDANTIC, "fields": fields, "dumps": dumps}))
"""


def test_dataclass_fallback_has_the_jax_fields_and_dumps():
    results = []
    for module in ("gat_recommendation_torch.serving.schemas", "gat_recommendation_tpu.serving.schemas"):
        out = subprocess.run([sys.executable, "-c", _FALLBACK_PROBE, module, json.dumps(CASES)], cwd=REPO,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        results.append(json.loads(out.stdout.strip().splitlines()[-1]))
    got, want = results
    assert got == want
    assert got["pydantic"] is False
    assert got["dumps"][0] == {"session_items": [3, 1, 3], "k": None}
