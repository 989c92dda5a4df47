"""Build the item co-occurrence graph (stage 04 of the data pipeline).

    python3 -m gat_recommendation_torch.scripts.data.build_graph [--input-file ...] ...

The port of ``scripts/data/04_build_graph.py``: the same flags, defaults and
files (the edge CSV, its packed npz beside it, the stats JSON), without
pandas (``data/graph.py``).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from gat_recommendation_torch.data.csv_io import read_csv
from gat_recommendation_torch.data.graph import build_co_event_graph, save_edges
from gat_recommendation_torch.utils.logging import get_logger


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Build co-occurrence graph")
    p.add_argument("--input-file", type=str, default="data/processed/train.csv")
    p.add_argument("--output-file", type=str, default="data/processed/graph_edges.csv")
    p.add_argument("--stats-file", type=str, default="data/processed/graph_stats.json")
    p.add_argument("--window", type=int, default=5)
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    logger = get_logger(__name__)
    sessions = read_csv(args.input_file, usecols=("session_id", "timestamp", "itemid", "event"))
    edges, stats = build_co_event_graph(sessions, window=args.window)
    out = Path(args.output_file)
    save_edges(edges, out, out.with_suffix(".npz"))
    Path(args.stats_file).parent.mkdir(parents=True, exist_ok=True)
    with open(args.stats_file, "w") as f:
        json.dump(stats, f, indent=2)
    logger.info(f"{stats['num_nodes']:,} nodes / {stats['num_edges']:,} edges "
                f"(avg degree {stats['avg_degree']:.2f}) -> {out} (+.npz)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
