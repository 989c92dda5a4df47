"""The port's subpackages export what the JAX package's export.

Every name in the ``__all__`` of each JAX subpackage (but
``utils.enable_persistent_cache``, which is for XLA's compilation cache)
imports from the port's subpackage of the same name, which lists the same
``__all__``. This runs in a fresh interpreter, where JAX is not imported by
the test session: importing the names must not import it. The serving path
stays light: importing ``serving.recommender`` does not import the Trainer,
and importing ``ops`` builds no kernel.

``predict_topk`` and ``bpr_loss_from_embeddings`` are held against the JAX
functions on the same seeded inputs: ids equal, scores and loss within 1e-5
(float32, summation order differs).
"""

import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gat_recommendation_torch.models import base as port_base
from gat_recommendation_tpu.models import base as jax_base

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SUBPACKAGES = ("data", "models", "ops", "parallel", "serving", "train", "utils")
NOT_PORTED = {"utils": {"enable_persistent_cache"}}

_JAX_ALL = """
import ast, json, sys
out = {}
for sub in sys.argv[1:]:
    tree = ast.parse(open(f"gat_recommendation_tpu/{sub}/__init__.py").read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__" for t in node.targets):
            out[sub] = ast.literal_eval(node.value)
print(json.dumps(out))
"""

_PORT_PROBE = """
import importlib, json, sys
want = json.loads(sys.argv[1])
missing, alls = {}, {}
for sub, names in want.items():
    mod = importlib.import_module(f"gat_recommendation_torch.{sub}")
    alls[sub] = list(mod.__all__)
    missing[sub] = [n for n in names if not hasattr(mod, n)]
    for n in names:
        exec(f"from gat_recommendation_torch.{sub} import {n}")
print(json.dumps({"missing": missing, "all": alls,
                  "jax": sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "gat_recommendation_tpu"))}))
"""

_LIGHT_PROBE = """
import json, sys
import gat_recommendation_torch.serving.recommender
import gat_recommendation_torch.ops
from gat_recommendation_torch.ops import _build
print(json.dumps({"trainer": "gat_recommendation_torch.train.trainer" in sys.modules,
                  "optimizers": "gat_recommendation_torch.train.optimizers" in sys.modules,
                  "loaded": sorted(_build._libs)}))
"""


def _run(code: str, *args: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code, *args], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def jax_all() -> dict:
    return _run(_JAX_ALL, *SUBPACKAGES)


def test_every_jax_subpackage_name_imports_from_the_port_without_jax(jax_all):
    assert set(jax_all) == set(SUBPACKAGES)
    want = {sub: [n for n in names if n not in NOT_PORTED.get(sub, set())] for sub, names in jax_all.items()}
    got = _run(_PORT_PROBE, json.dumps(want))
    assert got["missing"] == {sub: [] for sub in SUBPACKAGES}
    assert got["all"] == want
    assert got["jax"] == []


def test_serving_does_not_import_the_trainer_and_ops_builds_nothing():
    got = _run(_LIGHT_PROBE)
    assert got["trainer"] is False and got["optimizers"] is False
    assert got["loaded"] == []


def test_train_names_resolve_lazily_and_unknown_names_raise():
    from gat_recommendation_torch import train
    from gat_recommendation_torch.train.losses import create_loss_function
    from gat_recommendation_torch.train.trainer import Trainer

    assert train.Trainer is Trainer and train.create_loss_function is create_loss_function
    assert set(train.__all__) <= set(dir(train))
    with pytest.raises(AttributeError, match="no_such_name"):
        train.no_such_name  # noqa: B018


@pytest.mark.parametrize("num_items", [None, 900])
@pytest.mark.parametrize("B,V,D,k", [(3, 1024, 16, 20), (5, 32_768, 8, 10)])
def test_predict_topk_matches_jax(B, V, D, k, num_items):
    rng = np.random.default_rng(B * V + D)
    sess = rng.standard_normal((B, D)).astype(np.float32)
    table = rng.standard_normal((V, D)).astype(np.float32)
    want_i, want_s = jax_base.predict_topk(jnp.asarray(sess), jnp.asarray(table), k, num_items)
    got_i, got_s = port_base.predict_topk(torch.from_numpy(sess), torch.from_numpy(table), k, num_items)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_bpr_loss_from_embeddings_matches_jax(masked):
    rng = np.random.default_rng(7)
    B, K, D = 12, 5, 16
    sess, target = (rng.standard_normal((B, D)).astype(np.float32) for _ in range(2))
    neg = rng.standard_normal((B, K, D)).astype(np.float32)
    mask = (rng.random(B) < 0.6) if masked else None
    want = jax_base.bpr_loss_from_embeddings(jnp.asarray(sess), jnp.asarray(target), jnp.asarray(neg),
                                             None if mask is None else jnp.asarray(mask))
    got = port_base.bpr_loss_from_embeddings(torch.from_numpy(sess), torch.from_numpy(target), torch.from_numpy(neg),
                                             None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-6)
    empty = torch.zeros(B, dtype=torch.bool)
    assert port_base.bpr_loss_from_embeddings(torch.from_numpy(sess), torch.from_numpy(target),
                                              torch.from_numpy(neg), empty).item() == 0.0
