"""Parallelism: the ('data', 'model') mesh, its sharding rules, sharded steps.

The port of the JAX package's ``parallel/`` over ``torch.distributed``: one
process a GPU, batches split over 'data', the item table (and everything
shaped like it) row-sharded over 'model', everything else replicated. GSPMD
inserted the JAX package's collectives; here they are written out
(``parallel/steps.py``, ``ops/shard.py``): gradient sums over 'data', table
rows exchanged over 'model', BatchNorm statistics and the loss's sample count
summed over 'data', and a two-phase top-k (``parallel/topk.py``); chained
steps replay CUDA graphs with those collectives inside. The table
update of the eager sparse step is B1, kernel 3 on each row shard
(``ops/sparse_adamw.py::sharded_sparse_adamw``). The JAX package's
``parallel.__all__``.
"""

from gat_recommendation_torch.parallel.mesh import (
    batch_sharding,
    make_mesh,
    param_shardings,
    replicated,
    state_shardings,
)
from gat_recommendation_torch.parallel.steps import (
    make_sharded_eval_step,
    make_sharded_sparse_train_step,
    make_sharded_train_step,
)

__all__ = [
    "make_mesh",
    "param_shardings",
    "state_shardings",
    "batch_sharding",
    "replicated",
    "make_sharded_sparse_train_step",
    "make_sharded_train_step",
    "make_sharded_eval_step",
]
