"""Cross-cutting utilities: seeding, JSON and config IO, logging, timers and
roofline accounting. The JAX package's ``utils.__all__`` but
``enable_persistent_cache``, which is for XLA's compilation cache
(``ops/_build.py`` caches the port's kernel libraries)."""

from gat_recommendation_torch.utils.io import load_config, load_json, save_json
from gat_recommendation_torch.utils.logging import get_logger
from gat_recommendation_torch.utils.profiler import measure_memory, timer
from gat_recommendation_torch.utils.seed import set_seed

__all__ = [
    "load_config",
    "load_json",
    "save_json",
    "get_logger",
    "set_seed",
    "timer",
    "measure_memory",
]
