"""The first optimizer of a process keeps nothing of its caller alive.

``torch.optim``'s first optimizer imports ``torch._dynamo``, and a call made
during that import keeps its own frame in a reference cycle with every frame
above it, so the function that built the optimizer, and the model it held,
lived until a full collection. ``train/optimizers.py`` imports
``torch._dynamo`` at module level, so the frames kept are that import's.

Each case runs in a fresh interpreter with the collector disabled: the first
Trainer of the process (and a bare ``FusedEmbeddingAdamW.init``), built
inside a function and dropped, must be freed by reference counting alone
(its weak references dead, no ``gc.collect()``), as the second one is.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

_PROBE = """
import gc, json, sys, weakref
gc.disable()
import torch
from gat_recommendation_torch.models.registry import create_model
from gat_recommendation_torch.train.optimizers import FusedEmbeddingAdamW
from gat_recommendation_torch.train.trainer import Trainer

CASE = sys.argv[1]


def build():
    model = create_model("graph_transformer_optimized", 300, device="cpu", embedding_dim=16, hidden_dim=16,
                         laplacian_k=4)
    optimizer = FusedEmbeddingAdamW(1e-3, weight_decay=1e-5, lazy=CASE == "lazy_trainer")
    if CASE == "optimizer_init":
        state = optimizer.init(model)
        return [weakref.ref(model), weakref.ref(state["emb_mu"]), weakref.ref(state["rest"])]
    trainer = Trainer(model, lambda epoch: [], lambda: [], optimizer=optimizer, output_dir=sys.argv[2],
                      sparse_embedding_grads=CASE != "dense_trainer", chain=4, device="cpu")
    state = trainer.init_state()
    return [weakref.ref(trainer), weakref.ref(model.item_embedding), weakref.ref(state["emb_mu"])]


first = build()
first_alive = [r() is not None for r in first]
second = build()
print(json.dumps({"first_alive": first_alive, "second_alive": [r() is not None for r in second],
                  "gc_enabled": gc.isenabled()}))
"""


@pytest.mark.parametrize("case", ["lazy_trainer", "eager_trainer", "dense_trainer", "optimizer_init"])
def test_the_first_trainer_of_a_process_is_freed_when_dropped(case, tmp_path):
    out = subprocess.run([sys.executable, "-c", _PROBE, case, str(tmp_path)], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.splitlines()[-1])
    assert got == {"first_alive": [False] * 3, "second_alive": [False] * 3, "gc_enabled": False}
