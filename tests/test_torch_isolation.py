"""The PyTorch port stands alone: it imports neither JAX nor the JAX package, nor pandas.

The test session has already imported JAX (tests/conftest.py), so the import
check runs in a fresh interpreter. The optional packages (PyYAML, rich,
google-cloud-storage) are imported only inside the calls that use them.
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
                if m.split(".")[0] in ("jax", "jaxlib", "optax", "orbax", "pandas", "gat_recommendation_tpu",
                                       "yaml", "rich")
                or m.startswith("google.cloud.storage"))
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


_PARALLEL_PROBE = """
import sys
import gat_recommendation_torch.parallel
from gat_recommendation_torch.parallel import distributed, mesh, steps, topk
from gat_recommendation_torch.parallel.steps import make_chained_sharded_sparse_train_step, shard_chained_batch
from gat_recommendation_torch.scripts.pipeline import collective_accounting
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "optax", "orbax", "gat_recommendation_tpu"))
print(sorted(m for m in sys.modules if m.startswith("gat_recommendation_torch.parallel")), leaked)
"""


def test_the_parallel_package_stands_alone():
    """The mesh, its steps (the chained one too), the two-phase top-k, the
    process group and the collective accounting import in a fresh
    interpreter without JAX or the JAX package."""
    out = subprocess.run([sys.executable, "-c", _PARALLEL_PROBE], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("[]")
    for name in ("distributed", "mesh", "steps", "topk"):
        assert f"gat_recommendation_torch.parallel.{name}" in out.stdout


@pytest.mark.parametrize("entry,chain", [("bench", ["--chain", "1"]), ("train_baseline", ["--chain", "1"]),
                                         ("bench", []), ("train_baseline", [])],
                         ids=["bench", "train_baseline", "bench_default_chain", "train_baseline_default_chain"])
def test_the_mesh_entry_points_default_to_the_card_and_raise_without_one(entry, chain, monkeypatch):
    """``bench --mesh 1x1`` and ``train_baseline --mesh``, at chain 1 and at
    their default chain (32), ask for cuda (and its nccl backend) and raise
    where there is none; no mesh moves to the CPU or to gloo on its own."""
    import torch

    from gat_recommendation_torch import bench
    from gat_recommendation_torch.scripts.train import train_baseline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "bench":
            bench.main(["--mesh", "1x1", *chain, "--sessions", "100"])
        else:
            train_baseline.main(["--mesh", "--n-model", "1", *chain])


CLIS = ("train_baseline", "evaluate_local", "model_quality_gate", "run_full_pipeline")


@pytest.mark.parametrize("entry", ["create_model", "Trainer", "Recommender", *CLIS])
def test_every_entry_point_defaults_to_the_card_and_raises_without_one(entry, monkeypatch, tmp_path):
    """No entry point lands on the CPU quietly: without `device` (or
    ``--device``) each asks for cuda and raises where there is none."""
    import torch

    from gat_recommendation_torch.models.registry import create_model
    from gat_recommendation_torch.scripts import evaluate_local
    from gat_recommendation_torch.scripts.pipeline import model_quality_gate, run_full_pipeline
    from gat_recommendation_torch.scripts.train import train_baseline
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
        elif entry == "Recommender":
            Recommender(tmp_path / "no_checkpoint", tmp_path / "no_edges.csv", warmup=False)
        else:  # the command lines, on inputs they would read after choosing the device
            cli = {"train_baseline": train_baseline, "evaluate_local": evaluate_local,
                   "model_quality_gate": model_quality_gate, "run_full_pipeline": run_full_pipeline}[entry]
            cli.main([])
