"""The port's Trainer.train() on the CPU: against the JAX Trainer, resume,
checkpoints, early stop and the hits file.

Lazy optimizer, dropout 0, a tiny corpus whose sessions all fall into the
smallest node bucket (one compiled step on the JAX side). Tolerances: train
losses 1e-5 relative against the JAX package (float32, summation orders
differ), its validation metrics within 1e-9; a resumed port run against an
uninterrupted one 1e-6 relative and equal metrics (the same program on the
same state); lazy against eager checkpoint tables rtol 1e-3 / atol 2e-5
(the JAX package's bar: momentum-tail truncation and summation order).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from gat_recommendation_torch import convert
from gat_recommendation_torch.data import batching as port_batching
from gat_recommendation_torch.models import registry
from gat_recommendation_torch.serving.recommender import Recommender
from gat_recommendation_torch.serving.validation import validate_request
from gat_recommendation_torch.train import checkpoint, hits_io
from gat_recommendation_torch.train import trainer as port_trainer
from gat_recommendation_torch.train.losses import create_loss_function
from gat_recommendation_torch.train.optimizers import FusedEmbeddingAdamW
from gat_recommendation_tpu.data import batching as ref_batching
from gat_recommendation_tpu.models import create_model as jax_create_model
from gat_recommendation_tpu.train import hits_io as jax_hits_io
from gat_recommendation_tpu.train import trainer as ref_trainer
from gat_recommendation_tpu.train.losses import create_loss_function as jax_create_loss
from gat_recommendation_tpu.train.optimizers import FusedEmbeddingAdamW as JaxOptimizer

torch.set_num_threads(1)

V, DIM = 300, 32
HP = dict(learning_rate=1e-3, weight_decay=1e-5)
MODEL = dict(embedding_dim=DIM, hidden_dim=DIM, laplacian_k=4, dropout=0.0)


def _corpus(seed=0, sessions=96):
    """Sessions of 3-9 events: at most 8 context nodes, one bucket."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(3, 10, sessions)
    total = int(lengths.sum())
    sid, ts = np.repeat(np.arange(sessions), lengths), np.arange(total)
    items = rng.integers(1, V, total)
    edges = (rng.integers(1, V, 6000), rng.integers(1, V, 6000))
    df = pd.DataFrame({"session_id": sid, "timestamp": ts, "itemid": items})
    return (ref_batching.SessionDataset(df, edges, num_items=V),
            port_batching.SessionDataset((sid, ts, items), edges, num_items=V), edges)


def _jax_model(seed=0):
    model = jax_create_model("graph_transformer_optimized", num_items=V, **MODEL)
    params, state = model.init_params(jax.random.key(seed))
    pe = np.random.default_rng(seed).normal(0, 1, state["cached_pe"].shape).astype(np.float32)
    pe[V:] = 0.0
    state["cached_pe"] = jnp.asarray(pe)
    return model, params, state


def _port_model(jax_model, params, state):
    cfg = dataclasses.asdict(jax_model.config)
    model = registry.create_model(jax_model.name, cfg.pop("num_items"), device="cpu", **cfg)
    weights, buffers = convert.from_jax_params(params, state, dataclasses.asdict(jax_model.config))
    model.load_state_dict({**weights, **buffers})
    return model


@pytest.fixture(scope="module")
def setup():
    """Datasets, edges, the JAX model and its initial params and state as
    numpy trees (the JAX Trainer donates the arrays it is given)."""
    jax_ds, port_ds, edges = _corpus()
    jax_model, params, state = _jax_model()
    numpy_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return jax_ds, port_ds, edges, jax_model, numpy_tree(params), numpy_tree(state)


def _port_trainer(setup, out, *, lazy=True, val=True, **kw):
    _, port_ds, _, jax_model, params, state = setup
    trainer = port_trainer.Trainer(
        _port_model(jax_model, params, state),
        lambda epoch: port_batching.iterate_batches(port_ds, 16, shuffle=True, seed=epoch, engine="numpy"),
        (lambda: port_batching.iterate_batches(port_ds, 16, engine="numpy")) if val else (lambda: iter(())),
        optimizer=FusedEmbeddingAdamW(**HP, lazy=lazy),
        output_dir=out, loss_fn=create_loss_function("dual"), sparse_embedding_grads=True,
        device="cpu", **kw)
    trainer.init_state(reset_parameters=False)
    return trainer


def test_train_matches_the_jax_trainer(setup, tmp_path):
    jax_ds, _, _, jax_model, params, state = setup
    port = _port_trainer(setup, tmp_path / "port", max_epochs=2, record_hits=True)
    jt = ref_trainer.Trainer(
        jax_model,
        lambda epoch: ref_batching.iterate_batches(jax_ds, 16, shuffle=True, seed=epoch, engine="numpy"),
        lambda: ref_batching.iterate_batches(jax_ds, 16, engine="numpy"),
        optimizer=JaxOptimizer(**HP, use_pallas=False, lazy=True), output_dir=tmp_path / "jax",
        max_epochs=2, loss_fn=jax_create_loss("dual"), sparse_embedding_grads=True, record_hits=True)
    params, state = (jax.tree.map(jnp.asarray, t) for t in (params, state))
    want = jt.train(params, state, jt.optimizer.init(params))
    got = port.train()
    assert len(got["train_loss"]) == len(got["val_metrics"]) == 2
    np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=1e-5)
    for g, w in zip(got["val_metrics"], want["val_metrics"]):
        assert set(g) == set(w) == {"recall@10", "ndcg@10", "recall@20", "ndcg@20"}
        for key, value in w.items():
            assert g[key] == pytest.approx(value, abs=1e-9), key
    assert json.loads((tmp_path / "port" / "history.json").read_text()) == got
    for a, b in zip(jax_hits_io.load_hits(tmp_path / "port" / "hits_k10.npz"),
                    jax_hits_io.load_hits(tmp_path / "jax" / "hits_k10.npz")):
        np.testing.assert_array_equal(a, b)
    best = checkpoint.load_meta(tmp_path / "port" / "checkpoint_best")
    assert best["history"] == got and best["epoch"] in (0, 1)


def test_resumed_run_matches_an_uninterrupted_one(setup, tmp_path):
    straight = _port_trainer(setup, tmp_path / "straight", max_epochs=3)
    want = straight.train()
    _port_trainer(setup, tmp_path / "resumed", max_epochs=2).train()
    resumed = _port_trainer(setup, tmp_path / "resumed", max_epochs=3)
    got = resumed.train(resume=True)
    assert len(got["train_loss"]) == 3 and resumed.current_epoch == 2
    np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=1e-6)
    assert got["val_metrics"] == want["val_metrics"]
    assert resumed.opt_state["count"] == straight.opt_state["count"]
    torch.testing.assert_close(resumed.model.item_embedding, straight.model.item_embedding, rtol=1e-6, atol=1e-9)


def test_checkpoints_hold_the_materialized_table_and_serve(setup, tmp_path):
    _, _, edges, jax_model, _, _ = setup
    lazy = _port_trainer(setup, tmp_path / "lazy", max_epochs=2)
    lazy.train()
    eager = _port_trainer(setup, tmp_path / "eager", max_epochs=2, lazy=False)
    eager.train()
    cfg = dataclasses.asdict(jax_model.config)
    tables = {}
    for name, trainer in (("lazy", lazy), ("eager", eager)):
        # The serving loader, which knows nothing of the optimizer.
        model = registry.create_model(jax_model.name, cfg["num_items"], device="meta",
                                      **{k: v for k, v in cfg.items() if k != "num_items"})
        restored = checkpoint.restore_params_state(tmp_path / name / "checkpoint_latest", model, "cpu")
        tables[name] = restored.item_embedding.detach()
        assert torch.equal(tables[name], trainer.model.item_embedding.detach())
    torch.testing.assert_close(tables["lazy"], tables["eager"], rtol=1e-3, atol=2e-5)
    saved = torch.load(tmp_path / "lazy" / "checkpoint_latest" / "optimizer.pt", weights_only=True)
    assert int(saved["count"]) == lazy.opt_state["count"] > 0
    assert torch.all(saved["last_step"] == saved["count"])
    assert "last_step" not in torch.load(tmp_path / "eager" / "checkpoint_latest" / "optimizer.pt",
                                         weights_only=True)
    # A checkpoint written by train() serves through the unchanged Recommender.
    np.savetxt(tmp_path / "edges.csv", np.stack(edges, 1), fmt="%d", delimiter=",",
               header="item_i,item_j", comments="")
    rec = Recommender(tmp_path / "lazy" / "checkpoint_best", tmp_path / "edges.csv", device="cpu",
                      warmup=False)
    ids, scores = rec.recommend(validate_request(type("R", (), {"session_items": [3, 5, 8], "k": 10})(), V))
    assert len(ids) == 10 and np.all(np.isfinite(scores)) and not {3, 5, 8} & set(ids)


def test_early_stop_after_patience_evaluations_without_a_gain(setup, tmp_path):
    """No validation batches: every metric is 0, no evaluation improves."""
    trainer = _port_trainer(setup, tmp_path, max_epochs=10, patience=2, val=False)
    history = trainer.train()
    assert len(history["train_loss"]) == len(history["val_metrics"]) == 2
    assert checkpoint.load_meta(tmp_path / "checkpoint_latest")["epoch"] == 1
    assert not (tmp_path / "checkpoint_best").exists()


def test_backstop_save_when_the_last_epoch_is_not_evaluated(setup, tmp_path):
    trainer = _port_trainer(setup, tmp_path, max_epochs=3, eval_every=2, defer_best=False)
    history = trainer.train()
    assert len(history["train_loss"]) == 3 and len(history["val_metrics"]) == 1
    latest = checkpoint.load_meta(tmp_path / "checkpoint_latest")
    assert latest["epoch"] == 2 and latest["history"] == history
    assert checkpoint.load_meta(tmp_path / "checkpoint_best")["epoch"] == 1  # written at once
    saved = torch.load(tmp_path / "checkpoint_latest" / "optimizer.pt", weights_only=True)
    assert torch.all(saved["last_step"] == saved["count"])  # materialized before the backstop save
    resumed = _port_trainer(setup, tmp_path, max_epochs=3)
    resumed.load_checkpoint()
    assert resumed.current_epoch == 3 and resumed.opt_state["count"] == trainer.opt_state["count"]
    assert torch.equal(resumed.model.item_embedding, trainer.model.item_embedding)
    assert resumed.train(resume=True) == history  # nothing left to train


def test_hits_file_is_the_jax_packages_format(tmp_path):
    rng = np.random.default_rng(4)
    rows = [None, rng.integers(0, 2, 37).astype(np.int8), rng.integers(0, 2, 40).astype(np.int8),
            np.zeros(0, np.int8)]
    hits_io.save_hits(tmp_path / "port.npz", rows)
    jax_hits_io.save_hits(tmp_path / "jax.npz", rows)
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert set(a.files) == set(b.files) == {"packed", "lengths"}
        for key in a.files:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
    for got, want in zip(hits_io.load_hits(tmp_path / "jax.npz"), rows):
        assert (got is None and want is None) or np.array_equal(got, want)
