"""The port's train_baseline entry point against the JAX script.

On a 400-session corpus from the port's data stages, dropout 0, widths 32,
batch 32, 2 epochs: the JAX ``scripts/train/train_baseline.py`` runs
in-process and keeps the parameters and state it trained from (drawn by its
``init_state``, then the Laplacian encodings); the port's entry point builds
its datasets, model and Trainer from the same flags, takes those weights
through ``convert.py``, and trains. At chain 1 and 4, eager and lazy AdamW:
``history.json`` losses within 1e-5 relative (float32, summation orders
differ) and every validation metric within 1e-9 of the JAX script's.
"""

import numpy as np
import pytest
import torch
from quickstart_torch import SMALL_MODEL, data_flags, history, jax_train, make_corpus, numpy_engines, port_train

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def processed(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("corpus"))


@pytest.mark.parametrize("lazy", [False, True], ids=["eager", "lazy"])
@pytest.mark.parametrize("chain", [1, 4])
def test_train_baseline_matches_the_jax_script(processed, tmp_path, monkeypatch, chain, lazy):
    numpy_engines(monkeypatch)
    argv = [*data_flags(processed), *SMALL_MODEL, "--chain", str(chain), *(["--lazy-adamw"] if lazy else [])]
    start = jax_train([*argv, "--output-dir", str(tmp_path / "jax"), "--no-mesh"], monkeypatch)
    trainer = port_train([*argv, "--output-dir", str(tmp_path / "port")], start)
    assert (trainer.chained_dispatches > 0) == (chain > 1)
    got, want = history(tmp_path / "port"), history(tmp_path / "jax")
    assert len(got["train_loss"]) == len(want["train_loss"]) == 2
    np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=1e-5)
    for g, w in zip(got["val_metrics"], want["val_metrics"], strict=True):
        assert set(g) == set(w) == {"recall@10", "ndcg@10", "recall@20", "ndcg@20"}
        for key, value in w.items():
            assert g[key] == pytest.approx(value, abs=1e-9), key
    assert want["val_metrics"][-1]["recall@20"] > 0


def test_train_baseline_over_a_mesh_matches_the_jax_scripts_mesh(processed, tmp_path, monkeypatch):
    """``--mesh --chain 1`` (lazy AdamW) on the CPU: the port on a 1x1 mesh
    (one process, a gloo group of one), the JAX script on its 4x2 mesh over
    the 8 CPU devices (``--n-model 2``); the histories held as above, and the
    process group left at the end of the run."""
    from gat_recommendation_torch.parallel import distributed

    numpy_engines(monkeypatch)
    argv = [*data_flags(processed), *SMALL_MODEL, "--chain", "1", "--lazy-adamw", "--mesh"]
    start = jax_train([*argv, "--output-dir", str(tmp_path / "jax"), "--n-model", "2"], monkeypatch)
    try:
        trainer = port_train([*argv, "--output-dir", str(tmp_path / "port")], start)
        assert trainer.mesh is not None and tuple(trainer.mesh.shape) == (1, 1)
    finally:
        distributed.shutdown()
    got, want = history(tmp_path / "port"), history(tmp_path / "jax")
    np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=1e-5)
    for g, w in zip(got["val_metrics"], want["val_metrics"], strict=True):
        for key, value in w.items():
            assert g[key] == pytest.approx(value, abs=1e-9), key
