"""JSON and YAML config IO.

``load_config`` / ``save_config`` import PyYAML inside the call (it is on
the card's host and here, but not a dependency of importing the port).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import numpy as np


def load_config(path: str | Path) -> dict[str, Any]:
    """A YAML config file as a dict."""
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def save_config(config: dict[str, Any], path: str | Path) -> None:
    """A dict as YAML, keys in their order."""
    import yaml

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(config, f, sort_keys=False)


def save_json(data: Any, path: str | Path, indent: int = 2) -> None:
    """Data as JSON (numpy scalars and arrays as numbers and lists), the
    parent directories created."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(data, f, indent=indent, default=_json_default)


def load_json(path: str | Path) -> Any:
    with open(path) as f:
        return json.load(f)


def _json_default(obj: Any) -> Any:
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    raise TypeError(f"Object of type {type(obj)} is not JSON serializable")
