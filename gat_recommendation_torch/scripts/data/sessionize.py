"""Sessionize raw events (stage 02 of the data pipeline).

    python3 -m gat_recommendation_torch.scripts.data.sessionize [--input-file ...] ...

The port of ``scripts/data/02_sessionize.py``: the same flags, defaults and
files (the sessions CSV and the stats JSON), without pandas.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from gat_recommendation_torch.data.csv_io import read_csv, write_csv
from gat_recommendation_torch.data.sessionize import compute_session_stats, sessionize_events
from gat_recommendation_torch.utils.logging import get_logger


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Sessionize events")
    p.add_argument("--input-file", type=str, default="data/raw/events.csv")
    p.add_argument("--output-file", type=str, default="data/interim/sessions.csv")
    p.add_argument("--stats-file", type=str, default="data/interim/session_stats.json")
    p.add_argument("--gap-minutes", type=int, default=30)
    p.add_argument("--min-length", type=int, default=3)
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    logger = get_logger(__name__)
    events = read_csv(args.input_file)
    logger.info(f"Loaded {len(events['itemid']):,} events from {args.input_file}")

    sessions = sessionize_events(events, gap_minutes=args.gap_minutes, min_length=args.min_length)
    stats = compute_session_stats(sessions)
    write_csv(sessions, Path(args.output_file))
    Path(args.stats_file).parent.mkdir(parents=True, exist_ok=True)
    with open(args.stats_file, "w") as f:
        json.dump(stats, f, indent=2)
    logger.info(f"{stats['num_sessions']:,} sessions / {stats['num_events']:,} events "
                f"(mean length {stats['session_length_mean']:.2f}) -> {args.output_file}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
