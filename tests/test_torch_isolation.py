"""The PyTorch port stands alone: it imports neither JAX nor the JAX package, nor pandas.

The test session has already imported JAX (tests/conftest.py), so the import
check runs in a fresh interpreter.
"""

import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "gat_recommendation_torch"

_PROBE = """
import importlib, pkgutil, sys
import gat_recommendation_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "optax", "orbax", "pandas", "gat_recommendation_tpu"))
print(len(names), leaked)
"""


def test_importing_every_port_module_pulls_in_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    count, leaked = out.stdout.split(" ", 1)
    assert int(count) >= 25
    assert leaked.strip() == "[]"


@pytest.mark.parametrize(
    "path",
    sorted(p.relative_to(REPO).as_posix() for p in PORT.rglob("*") if p.suffix in (".py", ".cu", ".cuh")),
)
def test_no_port_source_names_the_jax_package(path):
    text = (REPO / path).read_text()
    assert "gat_recommendation_tpu" not in text
    assert not re.search(r"^\s*(import|from)\s+(jax|optax|orbax|pandas)\b", text, re.M)


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    text = (REPO / "chip_smoke.py").read_text()
    assert not re.search(
        r"^\s*(import|from)\s+(jax|optax|orbax|pandas|gat_recommendation_tpu)\b", text, re.M
    )


@pytest.mark.parametrize("entry", ["create_model", "Trainer", "Recommender"])
def test_every_entry_point_defaults_to_the_card_and_raises_without_one(entry, monkeypatch, tmp_path):
    """No entry point lands on the CPU quietly: without `device` each asks
    for cuda and raises where there is none."""
    import torch

    from gat_recommendation_torch.models.registry import create_model
    from gat_recommendation_torch.serving.recommender import Recommender
    from gat_recommendation_torch.train.trainer import Trainer

    small = dict(embedding_dim=8, hidden_dim=8, laplacian_k=4, num_layers=1, num_heads=2)
    model = create_model("graph_transformer_optimized", 50, device="cpu", **small)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "create_model":
            create_model("graph_transformer_optimized", 50, **small)
        elif entry == "Trainer":
            Trainer(model, lambda epoch: iter(()), lambda: iter(()))
        else:
            Recommender(tmp_path / "no_checkpoint", tmp_path / "no_edges.csv", warmup=False)
