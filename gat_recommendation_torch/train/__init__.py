"""Training layer: losses, metrics, train and eval steps, the Trainer.

The JAX package's ``train.__all__``, resolved at first access (PEP 562): the
serving path imports ``train.checkpoint``, which runs this file, and must not
pull in the Trainer, its CUDA graphs and its optimizers.
"""

from importlib import import_module

_MODULES = {
    "bpr_loss": "losses",
    "listwise_loss": "losses",
    "dual_loss": "losses",
    "sampled_softmax_loss": "losses",
    "create_loss_function": "losses",
    "compute_recall_at_k": "metrics",
    "compute_ndcg_at_k": "metrics",
    "compute_stratified_metrics": "metrics",
    "Trainer": "trainer",
}

__all__ = list(_MODULES)


def __getattr__(name: str):
    if name not in _MODULES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(import_module(f"{__name__}.{_MODULES[name]}"), name)


def __dir__() -> list[str]:
    return sorted(set(globals()) | set(__all__))
