"""The reference's data-loading names over the port's batcher.

``data/batching.py`` holds the bucketed fixed-shape batcher; this module
keeps the import surface that users of the reference (and of the JAX
package's ``train/dataloader.py``) know: ``SessionDataset``, ``collate_fn``,
``DataLoader`` and ``create_dataloader``.
"""

from __future__ import annotations

from pathlib import Path

from gat_recommendation_torch.data.batching import (  # noqa: F401
    DEFAULT_BUCKETS,
    SessionBatch,
    SessionDataset,
    collate,
    iterate_batches,
)
from gat_recommendation_torch.data.graph import load_edges

collate_fn = collate


class DataLoader:
    """Epoch-iterable over bucketed host SessionBatches; each iteration is
    one epoch (shuffled with ``seed + epoch`` when `shuffle`)."""

    def __init__(self, dataset: SessionDataset, batch_size: int, shuffle: bool,
                 seed: int = 0, engine: str = "auto"):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.engine = engine
        self._epoch = 0

    def __iter__(self):
        seed = self.seed + (self._epoch if self.shuffle else 0)
        self._epoch += 1
        return iterate_batches(self.dataset, self.batch_size, shuffle=self.shuffle, seed=seed,
                               engine=self.engine)

    def __len__(self) -> int:
        """Sessions over the batch size, rounded up (bucketing may add a few)."""
        return -(-len(self.dataset) // self.batch_size)


def create_dataloader(
    sessions_path: str | Path,
    graph_edges_path: str | Path,
    batch_size: int = 32,
    num_negatives: int = 5,
    max_session_length: int = 50,
    shuffle: bool = True,
    num_workers: int = 0,  # the reference's signature; batches are assembled by the batcher
    seed: int = 0,
) -> DataLoader:
    dataset = SessionDataset(sessions_path, load_edges(graph_edges_path), num_negatives=num_negatives,
                             max_session_length=max_session_length)
    return DataLoader(dataset, batch_size, shuffle, seed=seed)
