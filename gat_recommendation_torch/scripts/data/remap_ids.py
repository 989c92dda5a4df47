"""Optional stage 05 of the data pipeline: the contiguous item-id remap.

    python3 -m gat_recommendation_torch.scripts.data.remap_ids [--data-dir ...] [--output-dir ...]

The port of ``scripts/data/05_remap_ids.py``: rewrites train/val/test and
the graph with ids 1 .. num_unique, writes ``id_map.npy`` (contiguous ->
raw) and a ``split_info.json`` whose ``num_items`` is the dense catalog,
with the same files and bytes, without pandas.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from gat_recommendation_torch.data.csv_io import read_csv, write_csv
from gat_recommendation_torch.data.graph import load_edges
from gat_recommendation_torch.data.remap import build_id_map, remap_edges, remap_sessions
from gat_recommendation_torch.utils.logging import get_logger


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Contiguous item-id remap")
    p.add_argument("--data-dir", type=str, default="data/processed")
    p.add_argument("--output-dir", type=str, default="data/processed_dense")
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    logger = get_logger(__name__)
    src, dst = Path(args.data_dir), Path(args.output_dir)
    dst.mkdir(parents=True, exist_ok=True)

    frames = {name: read_csv(src / f"{name}.csv") for name in ("train", "val", "test")}
    npz = src / "graph_edges.npz"
    edges = load_edges(npz if npz.exists() else src / "graph_edges.csv")
    id_map = build_id_map(*frames.values(), edges)
    num_items = len(id_map) + 1  # + padding id 0
    logger.info(f"{len(id_map):,} distinct items -> contiguous catalog of {num_items:,} "
                f"(raw max id was {int(id_map.max()):,})")

    for name, columns in frames.items():
        write_csv(remap_sessions(columns, id_map), dst / f"{name}.csv")
    ei, ej = remap_edges(*edges, id_map)
    np.savez_compressed(dst / "graph_edges.npz", item_i=ei, item_j=ej)
    write_csv({"item_i": ei, "item_j": ej}, dst / "graph_edges.csv")
    np.save(dst / "id_map.npy", id_map)

    info = json.loads((src / "split_info.json").read_text())
    info["num_items"] = num_items
    info["raw_num_items"] = int(id_map.max()) + 1
    info["id_map_file"] = "id_map.npy"
    with open(dst / "split_info.json", "w") as f:
        json.dump(info, f, indent=2)
    logger.info(f"Dense artifacts -> {dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
