"""What the entries share in building the program's objects.

The program is ``gat_recommendation_torch``, built as its training script
(``scripts/train/train_baseline.py::build``) builds it: the datasets from
the sessions and the edges, ``create_model`` on the device, the fused
AdamW, the dual loss and a ``Trainer`` with sparse gradients, its chain and
its transfer threads, batches from ``iterate_batches`` with the assembly
threads. The weights are the benchmark's (``reference/model.py``), loaded
into the model before ``init_state(reset_parameters=False)``, as a caller
that sets the weights between ``build`` and ``run`` does.
"""

from __future__ import annotations

import math
import tempfile
from pathlib import Path

import numpy as np
import torch

from benchmark import corpus
from benchmark.reference import batches as rb
from benchmark.reference import model as rm

MODEL_FIELDS = ("embedding_dim", "hidden_dim", "num_layers", "num_heads", "dropout", "readout_type",
                "use_laplacian_pe", "laplacian_k", "use_ffn", "ffn_expansion")


def build_kernels(device) -> None:
    """The program's libraries, built into the checkout's ``build/`` on its
    first run (the CUDA kernels all at once where the card is), loaded."""
    from gat_recommendation_torch.data import native

    if torch.device(device).type == "cuda":
        try:
            from gat_recommendation_torch.ops import _build
        except ImportError:  # no builder to call ahead: the kernels build at first use
            _build = None
        if _build is not None:
            _build.build()
    native.available()


def prepare(cfg: dict, traffic: dict, seed: int, device, clock, split: str):
    """The set-up both entries share, timed by part: the program's imports and
    libraries, the corpus and its edges (`benchmark/corpus.py`), the dataset
    of `split` ("train" or "val"), the model as the program creates it, then
    the benchmark's weights from `seed` loaded into it. Returns (data,
    dataset, model, weights)."""
    with clock.part("imports"):
        import gat_recommendation_torch.train.trainer  # noqa: F401
        from gat_recommendation_torch.data.batching import SessionDataset
        from gat_recommendation_torch.models.registry import create_model
    with clock.part("kernel_build"):
        build_kernels(device)
    with clock.part("corpus_and_graph"):
        data = corpus.make(traffic["corpus"], cfg["num_items"], seed)
    with clock.part("datasets"):
        ds = SessionDataset(data[split], data["edges"], num_negatives=cfg["num_negatives"],
                            max_session_length=cfg["max_session_length"], num_items=cfg["num_items"])
    with clock.part("create_model"):
        model = create_model(cfg["model"], cfg["num_items"], device=device, **{k: cfg[k] for k in MODEL_FIELDS})
    with clock.part("weights"):
        weights = rm.draw_weights(cfg, seed, device)
        model.load_state_dict(weights, strict=True)
    return data, ds, model, weights


def trainer(cfg: dict, traffic: dict, model, seed: int, device, train_batches, val_batches):
    from gat_recommendation_torch.train.losses import create_loss_function
    from gat_recommendation_torch.train.optimizers import FusedEmbeddingAdamW
    from gat_recommendation_torch.train.trainer import Trainer

    optimizer = FusedEmbeddingAdamW(cfg["lr"], b1=cfg["b1"], b2=cfg["b2"], eps=cfg["eps"],
                                    weight_decay=cfg["weight_decay"], lazy=traffic["lazy"])
    t = Trainer(model, train_batches, val_batches, optimizer=optimizer,
                output_dir=Path(tempfile.gettempdir()) / "bench-trainer-output", max_epochs=1,
                k_values=traffic.get("k_values"),
                loss_fn=create_loss_function(cfg["loss"], cfg["alpha"], cfg["temperature"]), seed=seed,
                sparse_embedding_grads=True, chain=traffic["chain"],
                transfer_workers=traffic["transfer_workers"], device=device)
    t.init_state(reset_parameters=False)
    return t


def batches_per_epoch(unique_counts: np.ndarray, batch_size: int) -> list[int]:
    """The node bucket of each batch of an epoch, in order."""
    buckets = [rb.bucket_of(int(n)) for n in unique_counts]
    return [n for n in rb.BUCKETS for _ in range(math.ceil(buckets.count(n) / batch_size))]


def graphs_captured(step) -> int | None:
    """How many CUDA graphs a chained step holds (None where it keeps none)."""
    cache = getattr(step, "graphs", None)
    return len(cache.graphs) if cache is not None and hasattr(cache, "graphs") else None


def norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))
