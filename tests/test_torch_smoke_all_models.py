"""The port's ``smoke_test_all_models`` entry point on the CPU, against the
JAX package's ``scripts/smoke_test_all_models.py``.

The entry point must exit 0 with a PASS row for each of the four model
names; its synthetic batches must EQUAL the JAX script's (the same draws from
``np.random.default_rng(0)``); a model whose loss is not finite, or which
raises, is a FAIL row and the exit code is 1.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from gat_recommendation_torch import smoke_test_all_models as smoke
from gat_recommendation_torch.models.registry import MODEL_NAMES

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
FIELDS = ("node_ids", "node_mask", "adj", "num_nodes", "targets", "negatives", "sample_mask")


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_smoke", REPO / "scripts" / "smoke_test_all_models.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_smoke_entry_passes_every_model_on_the_cpu(capsys):
    assert smoke.main(["--device", "cpu"]) == 0
    rows = [line.split() for line in capsys.readouterr().out.splitlines()[1:]]
    assert [r[:2] for r in rows] == [[name, "PASS"] for name in MODEL_NAMES]
    assert all(np.isfinite(float(r[2])) and np.isfinite(float(r[3])) for r in rows)


def test_synthetic_batches_and_models_are_the_jax_scripts():
    jax_script = _jax_script()
    assert jax_script.MODELS == list(MODEL_NAMES) and jax_script.NUM_ITEMS == smoke.NUM_ITEMS
    for want, got in zip(jax_script.make_synthetic_batches(), smoke.make_synthetic_batches(), strict=True):
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)


@pytest.mark.parametrize("fault", ["nan", "raise"])
def test_a_failing_model_is_a_fail_row_and_exit_1(monkeypatch, capsys, fault):
    real = smoke.smoke_test

    def broken(name, batches, device):
        if name != "gat":
            return real(name, batches[:1], device)
        if fault == "raise":
            raise RuntimeError("boom")
        return {"pass": False}

    monkeypatch.setattr(smoke, "smoke_test", broken)
    monkeypatch.setattr(smoke, "EPOCHS", 1)
    assert smoke.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "gat" in out and out.count("PASS") == 3
    assert ("RuntimeError: boom" if fault == "raise" else "NaN loss") in out
